"""Scope the PyTorch port's modules to the test file that uses them.

Hypothesis draws example constants from every local, non-test module in
``sys.modules``.  A pytest-xdist worker runs many test files in one
process, so port modules left loaded there would change which examples
the JAX package's property tests (test_codec, test_qsq, test_plane_mask,
...) draw in that worker.  The ``test_torch_*.py`` files therefore import
``repro_torch`` only inside :func:`port_modules` — never while pytest
collects them — and the scope drops those modules again when the file is
done.  :func:`jax_config_scope` does the same for JAX config modules
that only one port test file loads.
"""
import contextlib
import sys


@contextlib.contextmanager
def port_modules():
    """Remove every ``repro_torch`` module first imported inside the block
    from ``sys.modules`` on exit (the objects stay alive while referenced)."""
    before = set(sys.modules)
    try:
        yield
    finally:
        for name in [m for m in sys.modules
                     if m not in before and m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]


@contextlib.contextmanager
def jax_config_scope():
    """Drop every ``repro.configs`` module first imported inside the block
    from ``sys.modules`` on exit."""
    before = set(sys.modules)
    try:
        yield
    finally:
        for name in [m for m in sys.modules
                     if m not in before and m.startswith("repro.configs.")]:
            del sys.modules[name]
