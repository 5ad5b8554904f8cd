"""entrypoints (PyTorch port of entrypoints/)."""
