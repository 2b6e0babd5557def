"""models for the PyTorch port."""
