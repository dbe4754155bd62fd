"""decoding of the PyTorch port."""
