"""Training for the PyTorch port."""
