"""pipeline (PyTorch port)."""
