"""Device programs of the PyTorch port."""
