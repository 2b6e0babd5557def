"""inference for the PyTorch port."""
