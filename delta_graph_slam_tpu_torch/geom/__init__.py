"""geom (PyTorch port)."""
