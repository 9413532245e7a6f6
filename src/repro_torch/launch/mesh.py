"""Device meshes and logical-axis sharding rules (the port of
``repro/launch/mesh.py``).

A :class:`Mesh` is a plan, not a set of devices: axis names and sizes.
The dry run (``launch/dryrun.py``) lays each parameter's logical axes onto
one with :func:`sharding_rules` to count per-device bytes.  Nothing here
builds a ``torch.distributed`` process group or a ``DeviceMesh``.

One card:    (1, 1)       axes ("data", "model")
Single pod:  (16, 16)     axes ("data", "model")         — 256 chips
Multi pod:   (2, 16, 16)  axes ("pod", "data", "model")  — 512 chips
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh; (1, 1) is one card."""
    return Mesh(("data", "model"), (data, model))


def data_axes(mesh: Mesh) -> tuple:
    """Mesh axes that carry the batch (pod is an outer DP axis)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def sharding_rules(mesh: Mesh, *, fsdp: bool = True) -> Mapping[str, tuple]:
    """Logical axis name -> mesh axes, the JAX package's table:

    * model-parallel dims (heads / mlp / vocab / experts) -> "model";
    * FSDP: the residual "embed" dim of weight matrices shards over "data"
      (+ "pod" when present); ``fsdp=False`` replicates it;
    * batch -> ("pod", "data"); decode kv-cache seq -> "model".
    """
    dp = data_axes(mesh)
    return {
        "batch": dp,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "heads_inner": ("model",),  # mamba d_inner / ssm heads
        "seq_kv": ("model",),  # decode caches: shard the sequence dim
        "seq_act": (),  # context parallelism (activations' seq dim): opt-in
        "embed": dp if fsdp else (),
        "layers": (),
    }


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape, strict=True))
