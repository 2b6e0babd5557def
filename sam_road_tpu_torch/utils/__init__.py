"""utils for the PyTorch port."""
