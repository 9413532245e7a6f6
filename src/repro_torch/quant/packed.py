"""Packed-weight serving from a dense parameter tree (the port of
``repro/quant/packed.py``).

:func:`pack_params` turns each large weight whose contraction axis is a
known logical axis ("embed" / "mlp" / "heads_inner") into a
:class:`~repro_torch.quant.store.PackedWeight`: interleaved bit-planes
``(.., K/32, 3, ..)`` of Table II codes (``sign_mag=False``,
``plane_major=False``, the default layout of the JAX package's kernels)
and scales ``(.., K/G, ..)``, stacked layer axes quantized independently.
``Model.prefill`` / ``Model.decode`` serve such a tree through the same
kernels as an artifact's plane-major tree (K3 and K1 on this layout).

Weights that stay dense: embeddings (gathered, not matmul'd), routers,
attention output projections, norms and biases, conv kernels, and every
leaf under ``min_numel``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.qsq import _quantize_impl
from repro_torch.models.base import ParamDesc, is_desc
from repro_torch.quant.store import (  # noqa: F401 -- axes/paths re-exported
    CONTRACT_AXES,
    EXCLUDE_PATHS,
    PackedWeight,
    QSQWeight,
    contract_idx,
    kernel_eligible,
)
from repro_torch.tree import keystr, tree_leaves_with_path, tree_map_with_path


def _fit_group(k: int, group_size: int) -> int:
    g = min(group_size, k)
    while k % g:
        g //= 2
    return max(g, 1)


def _should_pack(path: str, d: ParamDesc, min_numel: int) -> bool:
    if int(np.prod(d.shape)) < min_numel:
        return False
    return kernel_eligible(path, d)


def packed_param_descs(descs, group_size: int = 64, min_numel: int = 65536):
    """Descriptor tree of the packed form: packed leaves become PackedWeight
    nodes whose planes and scales are ParamDescs."""

    def leaf(path, d: ParamDesc):
        if not _should_pack(keystr(path), d, min_numel):
            return d
        idx = contract_idx(d)
        k = d.shape[idx]
        g = _fit_group(k, group_size)
        prefix_s, rest_s = d.shape[:idx], d.shape[idx + 1:]
        prefix_a, rest_a = d.axes[:idx], d.axes[idx + 1:]
        cname = d.axes[idx]
        return PackedWeight(
            planes=ParamDesc(prefix_s + (k // codec.PLANE_GROUP, 3) + rest_s,
                             prefix_a + (cname, None) + rest_a, dtype=torch.int32,
                             init="zeros"),
            scales=ParamDesc(prefix_s + (k // g,) + rest_s, prefix_a + (cname,) + rest_a,
                             dtype=torch.float32, init="zeros"),
            group_size=g, phi=4, rest_ndim=len(rest_s),
        )

    return tree_map_with_path(leaf, descs, is_leaf=is_desc)


def pack_params(params, descs, group_size: int = 64, min_numel: int = 65536,
                phi: int = 4, refit_alpha: bool = True):
    """Dense parameter tree -> the same tree with PackedWeight leaves (on the
    params' devices; the quantizer runs there, no kernel)."""

    def leaf(path, w, d: ParamDesc):
        if not _should_pack(keystr(path), d, min_numel):
            return w
        idx = contract_idx(d)
        g = _fit_group(d.shape[idx], group_size)
        levels, scales = _quantize_impl(w, phi=phi, group_size=g, assign="nearest",
                                        delta=2.0, gamma_frac=0.5,
                                        refit_alpha=refit_alpha, axis=idx)
        q = QSQWeight(levels=levels, scales=scales, group_size=g, phi=phi,
                      rest_ndim=len(d.shape) - idx - 1)
        return q.pack(sign_mag=False)

    return tree_map_with_path(leaf, params, descs)


def packed_bits_report(descs, group_size: int = 64, min_numel: int = 65536) -> dict:
    """Bits accounting for the packed form against the dense descriptors."""
    dense_bits = packed_bits = n_packed = 0
    for path, d in tree_leaves_with_path(descs, is_leaf=is_desc):
        numel = int(np.prod(d.shape))
        bits = 8 * numel * d.dtype.itemsize
        dense_bits += bits
        if _should_pack(keystr(path), d, min_numel):
            g = _fit_group(d.shape[contract_idx(d)], group_size)
            packed_bits += 3 * numel + 32 * (numel // g)
            n_packed += 1
        else:
            packed_bits += bits
    return {
        "dense_bits": dense_bits,
        "packed_bits": packed_bits,
        "savings": 1 - packed_bits / max(dense_bits, 1),
        "n_packed_leaves": n_packed,
    }
