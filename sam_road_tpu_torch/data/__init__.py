"""data for the PyTorch port."""
