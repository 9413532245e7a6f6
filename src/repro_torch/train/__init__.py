"""Serving steps of the PyTorch port."""
