"""Parameter descriptors (the port of ``repro/models/base.py``).

Models describe their parameters as a tree of :class:`ParamDesc` (shape +
logical axis names + init).  From one description come:

  * real tensors (:func:`init_params`), drawn from a ``torch.Generator``;
  * ``device="meta"`` stand-ins (:func:`abstract_params`), which the dry
    run (``launch/dryrun.py``) traces the steps on;
  * partition specs (:func:`partition_specs`): logical axes mapped to mesh
    axes by a rules dict, e.g. "mlp" -> ("model",), with any dim whose size
    its mesh axes do not divide left replicated.

The generator draws other numbers than ``jax.random`` from the same seed —
tests that compare the packages make their weights with numpy and pass
them to both.  A descriptor tree may hold WeightStore nodes whose fields
are descriptors (``quant.packed.packed_param_descs``); every function here
maps those fields and keeps the node.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

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


def _is_node(x) -> bool:
    """A descriptor, or a WeightStore node (a dataclass) holding descriptors."""
    return is_desc(x) or (dataclasses.is_dataclass(x) and not isinstance(x, type)
                          and any(is_desc(getattr(x, f.name)) for f in dataclasses.fields(x)))


def map_descs(fn, descs) -> Any:
    """``fn`` over every descriptor of a tree, into WeightStore nodes too."""
    def node(x):
        if is_desc(x):
            return fn(x)
        return dataclasses.replace(x, **{f.name: fn(getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if is_desc(getattr(x, f.name))})

    return tree_map(node, descs, is_leaf=_is_node)


def desc_leaves(descs) -> list[ParamDesc]:
    """Every descriptor of a tree, in :func:`map_descs`' order."""
    out: list[ParamDesc] = []
    map_descs(out.append, descs)
    return out


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
    return map_descs(lambda d: _init_one(d, generator, device), descs)


def abstract_params(descs) -> Any:
    """``device="meta"`` stand-ins of a descriptor tree: shapes, dtypes and
    strides, no storage and no generator (the dry run traces on them)."""
    return map_descs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), descs)


def spec_for_shape(shape, axes, rules: Mapping[str, Sequence[str]],
                   mesh_axis_sizes: Mapping[str, int]) -> tuple:
    """One tensor's partition spec from its logical axes, as a tuple with one
    entry a dim: None (replicated), a mesh axis name, or a tuple of names.
    A dim is sharded over its mapped mesh axes only if their product divides
    its size; a mesh axis shards at most one dim (the first dim wins)."""
    used: set = set()
    entries = []
    for size, name in zip(shape, axes, strict=True):
        mesh_axes = tuple(a for a in (rules.get(name, ()) if name else ()) if a not in used)
        prod = math.prod(mesh_axis_sizes[a] for a in mesh_axes)
        if mesh_axes and size % prod == 0:
            used.update(mesh_axes)
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        else:
            entries.append(None)
    return tuple(entries)


def partition_specs(descs, rules: Mapping[str, Sequence[str]],
                    mesh_axis_sizes: Mapping[str, int]) -> Any:
    """Logical axes -> a tree of partition specs (see :func:`spec_for_shape`)."""
    return map_descs(lambda d: spec_for_shape(d.shape, d.axes, rules, mesh_axis_sizes), descs)


# Activation rules.  The JAX package pins key activations to mesh axes with
# ``constrain`` under rules installed per launch; the port's tensors are
# unsharded, so ``constrain`` only checks its axes against the tensor, and
# the rules tell the MoE layer how many data shards route apart
# (:func:`data_shard_count`).
_ACT_RULES: dict = {}
_ACT_MESH = None


def set_activation_rules(rules: Mapping[str, Sequence[str]] | None, mesh=None) -> None:
    """Install ``rules`` on ``mesh`` (``launch.mesh.Mesh``), or clear them."""
    global _ACT_RULES, _ACT_MESH
    _ACT_RULES = dict(rules) if rules else {}
    _ACT_MESH = mesh


def _act_sizes() -> dict:
    return dict(zip(_ACT_MESH.axis_names, _ACT_MESH.shape, strict=True))


def constrain(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """x itself; with rules installed its spec is resolved first, so axes
    whose length differs from x's rank raise."""
    if _ACT_RULES and _ACT_MESH is not None:
        spec_for_shape(x.shape, axes, _ACT_RULES, _act_sizes())
    return x


def data_shard_count() -> int:
    """Product of the mesh axes that carry the batch under the installed
    rules (1 with none installed): the MoE layer's routing shards."""
    if not _ACT_RULES or _ACT_MESH is None:
        return 1
    sizes = _act_sizes()
    return math.prod(sizes[a] for a in _ACT_RULES.get("batch", ()) if a in sizes)


def count_params(descs) -> int:
    return sum(math.prod(d.shape) for d in desc_leaves(descs))


def param_bytes(descs) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in desc_leaves(descs))


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
