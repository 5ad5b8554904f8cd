"""pipelines (PyTorch port of compactfusion_tpu/pipelines)."""
