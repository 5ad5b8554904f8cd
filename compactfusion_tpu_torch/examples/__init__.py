"""examples (PyTorch port of examples/): run as ``python -m
compactfusion_tpu_torch.examples.<name>`` or under ``torchrun``."""
