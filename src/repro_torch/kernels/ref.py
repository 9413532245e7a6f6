"""Plain PyTorch versions of the QSQ kernels.

The port of ``repro/kernels/ref.py``: the simplest possible tensor code, no
tiling.  The kernel wrappers (``kernels/qsq.py``) run these for tensors that
lie on the CPU; on the card they are the yardstick each CUDA kernel is
held against, never a fallback.

Two code formats share the 3-bit planes: Table II offset codes
(``sign_mag=False``) and sign-magnitude codes (``sign_mag=True``).  Two
layouts: interleaved ``(K//32, 3, N)`` and plane-major ``(3, K//32, N)``
MSB-first, where a demand-dropped trailing plane is never read.

Precision contract (as the JAX reference's ``w.astype(x.dtype)`` before
the dot): the weight is the f32 product ``level * alpha``, rounded to x's
dtype, and the product with x is accumulated in f32.

The encoder's plain version, :func:`qsq_quantize_ref`, sums each group's
|w| in plain K order, as the CUDA kernel does, so the two agree bit for
bit on a card.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import codec
from repro_torch.core.qsq import (
    QSQConfig,
    _nearest_levels,
    codes_to_levels,
    levels_to_codes,
    smcodes_to_levels,
)

# The three plane masks a quality tier can put on a row: keep all 3 code
# planes, drop the LSB plane, drop the two LSB planes (drop = 0, 1, 2).
# Demand-driven dispatch restricts a call to ``MASK_VARIANTS[demand_drop:]``.
MASK_VARIANTS = (0b111, 0b110, 0b100)

# Calls of the plain matmuls and the plain encoder, by name: the main
# paths on a card must leave these at 0 (chip_smoke.py checks it).
calls: collections.Counter = collections.Counter()


def _unpack_codes(planes: torch.Tensor, plane_major: bool, n_planes: int = 3):
    if plane_major:
        return codec.unpack_bitplane_major(planes[:n_planes])
    return codec.unpack_bitplane(planes)


def _decode(codes: torch.Tensor, sign_mag: bool) -> torch.Tensor:
    lev = smcodes_to_levels(codes) if sign_mag else codes_to_levels(codes)
    return lev.to(torch.float32)


def _scale(levels: torch.Tensor, scales: torch.Tensor, group_size: int) -> torch.Tensor:
    k = levels.shape[0]
    lev_g = levels.reshape(k // group_size, group_size, *levels.shape[1:])
    return (lev_g * scales.unsqueeze(1)).reshape(levels.shape)


def qsq_dequant_ref(planes, scales, group_size: int, *, sign_mag: bool = False,
                    plane_major: bool = False, n_planes: int = 3,
                    code_mask: int = 0b111) -> torch.Tensor:
    """Bit-plane packed codes + per-group scales -> dense (K, N) f32 weights,
    with ``code_mask`` ANDed onto every code first (``decode(codes & mask)``
    equals a plain decode of plane-truncated words)."""
    codes = _unpack_codes(planes, plane_major, n_planes)
    return _scale(_decode(codes & code_mask, sign_mag), scales, group_size)


def qsq_dequant_masked_ref(planes, scales, group_size: int, code_mask: int, *,
                           sign_mag: bool = False, plane_major: bool = False,
                           n_planes: int = 3) -> torch.Tensor:
    """Dequant with ``code_mask`` ANDed onto every 3-bit code first: on
    full-quality planes it equals a plain decode of planes whose dropped
    LSB words were zeroed (``PackedWeight.truncate``)."""
    return qsq_dequant_ref(planes, scales, group_size, sign_mag=sign_mag,
                           plane_major=plane_major, n_planes=n_planes, code_mask=code_mask)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.astype(x.dtype), products accumulated in f32."""
    return torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))


def qsq_matmul_ref(x, planes, scales, group_size: int, *, sign_mag: bool = False,
                   plane_major: bool = False, n_planes: int = 3) -> torch.Tensor:
    """x (M, K) @ dequant(planes, scales) (K, N) -> (M, N) f32."""
    calls["qsq_matmul_ref"] += 1
    w = qsq_dequant_ref(planes, scales, group_size, sign_mag=sign_mag,
                        plane_major=plane_major, n_planes=n_planes)
    return _dot(x, w)


def qsq_matmul_masked_ref(xs, planes, scales, group_size: int, *,
                          sign_mag: bool = False, plane_major: bool = False,
                          demand_drop: int = 0) -> torch.Tensor:
    """Per-row plane-masked matmul: xs (3 - demand_drop, M, K) -> (M, N) f32.

    ``xs[i]`` holds the rows of x whose plane mask is
    ``MASK_VARIANTS[demand_drop + i]`` (other rows zeroed); each variant
    contracts against the weight decoded under its mask and the variants
    sum, so row m equals ``x[m] @ dequant(truncate(drop_m))``.
    """
    calls["qsq_matmul_masked_ref"] += 1
    n_planes = 3 - demand_drop
    out = None
    for i, mask in enumerate(MASK_VARIANTS[demand_drop:]):
        w = qsq_dequant_ref(planes, scales, group_size, sign_mag=sign_mag,
                            plane_major=plane_major, n_planes=n_planes, code_mask=mask)
        d = _dot(xs[i], w)
        out = d if out is None else out + d
    return out


def variant_split(x: torch.Tensor, plane_mask: torch.Tensor,
                  demand_drop: int) -> torch.Tensor:
    """(M, K) x + (M,) per-row code masks -> the (3 - demand_drop, M, K)
    stack the masked reference takes: ``xs[i]`` keeps exactly the rows masked
    ``MASK_VARIANTS[demand_drop + i]``.  A row whose mask matches no demanded
    variant is zero in every slice, so its output row is zero."""
    sel = torch.stack([plane_mask == v for v in MASK_VARIANTS[demand_drop:]])
    return torch.where(sel[:, :, None], x[None], torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


def qsq_matmul_plane_mask_ref(x, plane_mask, planes, scales, group_size: int, *,
                              sign_mag: bool = False, plane_major: bool = False,
                              demand_drop: int = 0) -> torch.Tensor:
    """The masked reference on a per-row ``plane_mask`` (M,) int32 operand —
    the form the masked CUDA kernels take."""
    return qsq_matmul_masked_ref(variant_split(x, plane_mask, demand_drop), planes,
                                 scales, group_size, sign_mag=sign_mag,
                                 plane_major=plane_major, demand_drop=demand_drop)


def qsq_quantize_ref(w: torch.Tensor, group_size: int, phi: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-level QSQ encode of w (K, N) f32/bf16, grouped along K ->
    (Table II codes (K, N) uint8, scales (K//G, N) f32).

    The JAX package's ``quantize(w, QSQConfig(phi, G, assign="nearest"))``;
    |w| is summed over each group as a loop of tensor adds in K order (not
    ``.sum()``) and every quotient is a tensor-by-tensor division (a
    division by a Python scalar may run as a multiply by its reciprocal on
    the card), which is the CUDA kernel's arithmetic exactly.
    """
    calls["qsq_quantize_ref"] += 1
    k, n = w.shape
    wg = w.to(torch.float32).reshape(k // group_size, group_size, n)
    acc = torch.abs(wg[:, 0])
    for i in range(1, group_size):
        acc = acc + torch.abs(wg[:, i])
    alpha = acc / torch.full((), float(phi * group_size), device=w.device)
    safe = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    levels = _nearest_levels(wg, safe[:, None], QSQConfig(phi=phi).max_level)
    return levels_to_codes(levels.reshape(k, n)), alpha
