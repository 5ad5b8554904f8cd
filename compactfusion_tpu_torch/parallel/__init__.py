"""parallel (PyTorch port of compactfusion_tpu/parallel)."""
