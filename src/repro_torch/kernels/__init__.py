"""Packed-matmul kernels of the PyTorch port: CUDA sources under ``csrc/``,
their wrappers (``qsq``), plain versions (``ref``) and dispatch."""
