"""register (PyTorch port)."""
