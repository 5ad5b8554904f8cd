"""compact (PyTorch port of compactfusion_tpu/compact)."""
