"""ops (PyTorch port of compactfusion_tpu/ops)."""

from compactfusion_tpu_torch.ops.attention import attn_with_lse  # noqa: F401
from compactfusion_tpu_torch.ops.merge import merge_out_lse  # noqa: F401
