"""detection of the PyTorch port."""
