"""Codec, quantizer and policy of the PyTorch port."""
