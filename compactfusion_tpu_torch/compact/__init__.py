"""compact (PyTorch port of compactfusion_tpu/compact)."""

from compactfusion_tpu_torch.compact.codecs import (  # noqa: F401
    decode,
    encode,
    payload_nbytes,
    sim_roundtrip,
)
from compactfusion_tpu_torch.compact.engine import (  # noqa: F401
    EFState,
    ef_compress,
    ef_decompress,
    init_ef_state,
)
from compactfusion_tpu_torch.compact.lowrank import subspace_iter  # noqa: F401
