"""The QSQ kernels of the PyTorch port: CUDA sources under ``csrc/``, their
wrappers (``qsq``), plain versions (``ref``) and dispatch.

``qsq_quantize``/``pack_weight`` encode a dense weight (K5); ``qsq_matmul``
and ``qsq_matvec`` multiply by the packed result (K3, K1)."""
from repro_torch.kernels import ref
from repro_torch.kernels.qsq import pack_weight, qsq_matmul, qsq_matvec, qsq_quantize

__all__ = ["pack_weight", "qsq_matmul", "qsq_matvec", "qsq_quantize", "ref"]
