"""Carry parameter trees and training states across from the JAX package.

``params_from_numpy(tree, device)`` takes the JAX package's parameter tree
as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's: the same nested dicts of tensors on ``device``.
bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16, 2 bytes per element)
cross bit for bit.  ``train_state_from_numpy``/``train_state_to_numpy`` do
the same for a whole ``TrainState`` (params, AdamW ``m``/``v``/``step``,
error-feedback ``err``).  Quantized weights cross through the shared
artifact npz, checkpoints through the shared checkpoint npz.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.base import resolve_device
from repro_torch.tree import tree_map


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree, device="cuda"):
    """JAX parameter tree (numpy leaves) -> the port's tree on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(device), tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy` (bfloat16 leaves come back as
    float32 numpy arrays; numpy has no bfloat16 of its own)."""
    def _np(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(_np, tree)


def train_state_from_numpy(state, device="cuda"):
    """A JAX ``TrainState`` with numpy leaves (any object with its
    ``params``/``opt.m``/``opt.v``/``opt.step``/``err`` fields) -> the
    port's ``TrainState`` on ``device``."""
    from repro_torch.optim import OptState
    from repro_torch.train.state import TrainState

    opt = OptState(m=params_from_numpy(state.opt.m, device),
                   v=params_from_numpy(state.opt.v, device),
                   step=params_from_numpy(state.opt.step, device))
    return TrainState(params=params_from_numpy(state.params, device), opt=opt,
                      err=params_from_numpy(state.err, device))


def train_state_to_numpy(state):
    """Inverse of :func:`train_state_from_numpy`: the port's ``TrainState``
    with numpy leaves, field for field the JAX ``TrainState``'s."""
    return params_to_numpy(state)
