"""utils (PyTorch port)."""
