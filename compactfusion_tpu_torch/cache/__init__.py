"""cache (PyTorch port of compactfusion_tpu/cache)."""

from compactfusion_tpu_torch.cache.accel import (  # noqa: F401
    CacheAccelConfig,
    CacheAccelState,
    init_cache_state,
    should_skip,
)
