"""QSQ over parameter trees, the legacy API over :mod:`repro_torch.quant.store`
(the port of ``repro/quant/pytree.py``).

The paper's "encode the model before the channel, decode at the edge"
layer: any parameter tree becomes a :class:`QuantizedParams` (QSQWeight
leaves for the quantized leaves, the rest untouched), crosses the channel
as the 3-bit wire form and is decoded back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.policy import QuantPolicy
from repro_torch.quant import store as _store
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class QuantizedParams:
    """A parameter tree whose selected leaves are QSQWeight, the others tensors."""

    tree: Any

    def dequantize(self, like=None):
        return dequantize_pytree(self, like)


def quantize_pytree(params, policy: QuantPolicy, descs=None) -> QuantizedParams:
    """Quantize every leaf the policy selects; keep the rest untouched.

    With ``descs`` (ParamDesc tree), matmul weights are grouped along their
    contraction axis (the serving-kernel layout); without, grouping runs
    along axis 0, and 4-D conv weights use the channel-major view (Fig. 5).
    """
    return QuantizedParams(tree=_store.quantize_tree(params, policy, descs))


def dequantize_pytree(qp: QuantizedParams, like=None):
    """Decode every quantized leaf back to a dense tensor; ``like`` (a
    matching tree of tensors or ParamDescs) gives the dtypes, f32 otherwise."""
    return _store.dense_tree(qp.tree, like)


def pytree_bits_report(params, qp: QuantizedParams) -> dict:
    """Eq. 11/12 accounting over a whole model (Fig. 9)."""
    full_bits = sum(8 * leaf.numel() * leaf.element_size() for leaf in tree_leaves(params))
    rep = _store.tree_bits_report(qp.tree)
    return {
        "full_bits": full_bits,
        "quantized_bits": rep["bits"],
        "memory_savings": 1.0 - rep["bits"] / max(full_bits, 1),
        "n_quantized_leaves": rep["n_store_leaves"],
        "n_leaves": rep["n_leaves"],
    }


def pack_pytree_wire(qp: QuantizedParams):
    """QuantizedParams -> tree of wire dicts / numpy arrays (the npz payload)."""
    return _store.tree_to_wire(qp.tree)


def unpack_pytree_wire(wire, device="cuda") -> QuantizedParams:
    """Inverse of :func:`pack_pytree_wire` (lossless), tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    from repro_torch.models.base import resolve_device

    return QuantizedParams(tree=_store.tree_from_wire(wire, resolve_device(device)))
