"""ops for the PyTorch port."""
