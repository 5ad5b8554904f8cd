"""schedulers (PyTorch port of compactfusion_tpu/schedulers)."""
