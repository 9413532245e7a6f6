"""Parameter descriptors (the port of ``repro/models/base.py``).

Models describe their parameters as a tree of :class:`ParamDesc` (shape +
logical axis names + init); :func:`init_params` materializes real tensors
from a ``torch.Generator``.  The generator draws other numbers than
``jax.random`` from the same seed — tests that compare the packages make
their weights with numpy and pass them to both.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    """One parameter: shape, per-dim logical axes, dtype, initializer."""

    shape: tuple
    axes: tuple
    dtype: Any = torch.float32
    init: str = "fan_in"  # fan_in | normal | zeros | ones | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without CUDA
    raises here instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path")
    return dev


def _init_one(d: ParamDesc, generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[0], 1)
        std = d.scale / np.sqrt(fan_in)
    elif d.init == "normal":
        std = d.scale * 0.02
    elif d.init == "small":
        std = d.scale * 0.006
    else:
        raise ValueError(f"unknown init {d.init!r}")
    w = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=device)
    return (w * float(std)).to(d.dtype)


def init_params(descs, generator: torch.Generator | None = None, device="cuda") -> Any:
    """Materialize tensors on ``device`` from a descriptor tree, drawing from
    ``generator`` (a fresh one seeded 0 on ``device`` when None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return tree_map(lambda d: _init_one(d, generator, device), descs, is_leaf=is_desc)


def dense(d_in: int, d_out: int, in_ax: str | None, out_ax: str | None,
          dtype=torch.float32, **kw) -> ParamDesc:
    return ParamDesc((d_in, d_out), (in_ax, out_ax), dtype=dtype, **kw)


def stacked(n: int, desc: ParamDesc, axis_name: str | None = "layers") -> ParamDesc:
    """Prepend a stacked layer axis."""
    return ParamDesc((n, *desc.shape), (axis_name, *desc.axes), dtype=desc.dtype,
                     init=desc.init, scale=desc.scale)


def map_stacked(n: int, tree, axis_name: str | None = "layers"):
    """stacked() over a whole descriptor tree."""
    return tree_map(lambda d: stacked(n, d, axis_name), tree, is_leaf=is_desc)
