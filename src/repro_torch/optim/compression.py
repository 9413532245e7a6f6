"""QSQ gradient compression with error feedback (the port of
``repro/optim/compression.py``).

Each compressible gradient leaf (two or more dimensions, at least
``min_numel`` values) plus its error-feedback residual is flattened to
(L, rest) and QSQ-encoded along its leading axis: 3-bit Table II codes and
one f32 scale per group.  The encode runs through the K5 kernel
(``kernels.qsq_quantize``) for CUDA tensors and its plain version for CPU
tensors; the decode (level x scale) is plain tensor code.  The decoded
gradient is what would cross the wire; the quantization residual goes
into the error-feedback buffer for the next step.

The grouping is the reference's, kept exactly: a stacked leaf (L, ...)
groups along the layer axis L, so a 30-layer stack encodes with G = 2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.qsq import codes_to_levels
from repro_torch.kernels import qsq
from repro_torch.models.base import ParamDesc, is_desc
from repro_torch.tree import tree_map, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    enabled: bool = False
    phi: int = 4
    group_size: int = 64
    min_numel: int = 4096  # small leaves cross uncompressed


def _compressible(shape) -> bool:
    return len(shape) >= 2


def compression_state_descs(param_descs, cc: GradCompressionConfig):
    """Error-feedback residual buffers (f32) for compressible leaves; a ()
    placeholder for the rest (keeps the tree structure aligned)."""

    def leaf(d: ParamDesc) -> ParamDesc:
        if cc.enabled and _compressible(d.shape) and int(np.prod(d.shape)) >= cc.min_numel:
            return ParamDesc(d.shape, d.axes, dtype=torch.float32, init="zeros")
        return ParamDesc((), (), dtype=torch.float32, init="zeros")

    return tree_map(leaf, param_descs, is_leaf=is_desc)


def _leaf_group(shape, group_size: int) -> int:
    g = group_size
    while shape[0] % g != 0 and g > 1:
        g //= 2
    return max(g, 1)


def _decode(codes: torch.Tensor, scales: torch.Tensor, group_size: int) -> torch.Tensor:
    """Table II codes (K, N) x per-group scales (K//G, N) -> (K, N) f32."""
    k, n = codes.shape
    lev = codes_to_levels(codes).to(torch.float32).reshape(k // group_size, group_size, n)
    return (lev * scales[:, None, :]).reshape(k, n)


def compress_grads(grads, err_state, cc: GradCompressionConfig):
    """(grads, err) -> (decoded grads as transmitted, new err, wire bytes).

    The wire bytes, (3 bits per value + 32 per scale) / 8 summed over the
    compressed leaves, follow from the shapes alone and come back as a
    Python float."""
    if not cc.enabled:
        return grads, err_state, 0.0
    wire_bits = 0
    residual = {}

    def leaf(path, g, e):
        nonlocal wire_bits
        if e.dim() == 0:  # not compressed
            residual[path] = e
            return g
        g32 = g.to(torch.float32) + e
        flat = g32.reshape(g32.shape[0], -1)
        gs = _leaf_group(flat.shape, cc.group_size)
        codes, scales = qsq.qsq_quantize(flat, group_size=gs, phi=cc.phi)
        dec = _decode(codes, scales, gs).reshape(g32.shape)
        wire_bits += 3 * flat.numel() + 32 * scales.numel()
        residual[path] = g32 - dec
        return dec.to(g.dtype)

    dec_grads = tree_map_with_path(leaf, grads, err_state)
    new_err = tree_map_with_path(lambda path, _: residual[path], grads)
    return dec_grads, new_err, wire_bits / 8.0
