"""utils (PyTorch port of compactfusion_tpu/utils)."""

from compactfusion_tpu_torch.utils.logger import init_logger  # noqa: F401
from compactfusion_tpu_torch.utils.prof import Profiler  # noqa: F401
