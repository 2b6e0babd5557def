"""graph for the PyTorch port."""
