"""models (PyTorch port of compactfusion_tpu/models)."""
