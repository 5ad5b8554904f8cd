"""ops (PyTorch port of compactfusion_tpu/ops)."""
