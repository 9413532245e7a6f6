"""PyTorch/CUDA port of the QSQ serving system.

The package mirrors the JAX package's module names (``core``, ``quant``,
``kernels``, ``models``, ``train``, ``serve``, ``api``) and imports neither
JAX nor anything of it.  Its entry points take an explicit ``device``
that defaults to ``"cuda"``.
"""
