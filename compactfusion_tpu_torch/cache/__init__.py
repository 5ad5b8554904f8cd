"""cache (PyTorch port of compactfusion_tpu/cache)."""
