"""utils (PyTorch port of compactfusion_tpu/utils)."""
