"""PyTorch/CUDA port of the QSQ serving and training system.

The package mirrors the JAX package's module names (``core``, ``quant``,
``kernels``, ``models``, ``optim``, ``train``, ``checkpoint``, ``data``,
``launch``, ``serve``, ``api``) and imports neither JAX nor anything of
it.  Its entry points take an explicit ``device`` that defaults to
``"cuda"``.
"""
