"""io (PyTorch port of compactfusion_tpu/io)."""
