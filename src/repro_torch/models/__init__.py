"""Model families of the PyTorch port (dense decoder so far)."""
