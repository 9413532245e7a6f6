"""AdamW as plain tensor code (the port of ``repro/optim/adamw.py``).

Not ``torch.optim.AdamW``: the JAX package clips by the global gradient
norm inside the update, decays only leaves of two or more dimensions, and
keeps f32 moments whatever the parameter dtype; this module does the
same, functionally (new tensors, the inputs untouched).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.base import ParamDesc, is_desc
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # () int32


def adamw_init_descs(param_descs) -> OptState:
    """Descriptor tree for the optimizer state (f32 moments, zeros)."""

    def f32_zeros(d: ParamDesc) -> ParamDesc:
        return ParamDesc(d.shape, d.axes, dtype=torch.float32, init="zeros")

    m = tree_map(f32_zeros, param_descs, is_leaf=is_desc)
    v = tree_map(f32_zeros, param_descs, is_leaf=is_desc)
    return OptState(m=m, v=v, step=ParamDesc((), (), dtype=torch.int32, init="zeros"))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(a.to(torch.float32) ** 2) for a in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, grads, opt: OptState,
                 lr_scale: torch.Tensor | float = 1.0):
    """One AdamW step.  Returns (new_params, new_opt, grad_norm)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = opt.step + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale
    out = {}

    def upd(path, p, g, m, v):
        g32 = g.to(torch.float32) * clip
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        out[path] = (m2, v2)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    new_params = tree_map_with_path(upd, params, grads, opt.m, opt.v)
    new_m = tree_map_with_path(lambda path, _: out[path][0], params)
    new_v = tree_map_with_path(lambda path, _: out[path][1], params)
    return new_params, OptState(m=new_m, v=new_v, step=step), gnorm
