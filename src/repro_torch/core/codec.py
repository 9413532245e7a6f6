"""Bit-level packing of QSQ codes (the port of ``repro/core/codec.py``).

Two physical layouts:

* **Dense pack** (`pack_dense` / `unpack_dense`): 10 3-bit codes per int32
  word (or 16 2-bit codes for ternary) — the wire/checkpoint format.
* **Bit-plane pack** (`pack_bitplane` / `unpack_bitplane`): the 3 bits of 32
  consecutive codes are split into 3 int32 words (one per bit position) —
  the kernel format.  `plane_major` moves the plane axis outermost, MSB
  first, so a truncated tier's planes are a contiguous leading prefix.

Every function takes and returns tensors on the caller's device.  Shifts
run on int32 and are masked right after, so the arithmetic shift of a word
with its top bit set never leaks sign bits into a code.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

DENSE_CODES_PER_WORD = {3: 10, 2: 16}
PLANE_GROUP = 32  # codes per bit-plane word


def _to_i32(bits: torch.Tensor) -> torch.Tensor:
    """Reinterpret low 32 bits held in int64 as int32 (two's complement)."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


# --------------------------------------------------------------------------
# Dense (wire) format
# --------------------------------------------------------------------------
def dense_words(n_codes: int, bits: int = 3) -> int:
    per = DENSE_CODES_PER_WORD[bits]
    return (n_codes + per - 1) // per


def pack_dense(codes: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Pack a flat uint8 code tensor into int32 words (wire format)."""
    per = DENSE_CODES_PER_WORD[bits]
    n = codes.shape[0]
    nw = dense_words(n, bits)
    lanes = torch.zeros(nw * per, dtype=torch.int64, device=codes.device)
    lanes[:n] = codes.to(torch.int64)
    shifts = torch.arange(per, dtype=torch.int64, device=codes.device) * bits
    word = torch.sum(lanes.reshape(nw, per) << shifts[None, :], dim=1)
    return _to_i32(word)


def unpack_dense(words: torch.Tensor, n_codes: int, bits: int = 3) -> torch.Tensor:
    """Inverse of :func:`pack_dense`."""
    per = DENSE_CODES_PER_WORD[bits]
    shifts = torch.arange(per, dtype=torch.int32, device=words.device) * bits
    lanes = (words.to(torch.int32)[:, None] >> shifts[None, :]) & ((1 << bits) - 1)
    return lanes.reshape(-1)[:n_codes].to(torch.uint8)


# --------------------------------------------------------------------------
# Bit-plane (kernel) format
# --------------------------------------------------------------------------
def pack_bitplane(codes: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Pack codes (K, ...) -> (K // 32, bits, ...) int32 bit-planes.

    Bit p of word [g, p, ...] holds bit p of code ``codes[g*32 + j, ...]``
    at bit position j.
    """
    k = codes.shape[0]
    if k % PLANE_GROUP != 0:
        raise ValueError(f"K={k} must be a multiple of {PLANE_GROUP}")
    c = codes.to(torch.int64).reshape(k // PLANE_GROUP, PLANE_GROUP, *codes.shape[1:])
    j = torch.arange(PLANE_GROUP, dtype=torch.int64, device=codes.device).reshape(
        (1, PLANE_GROUP) + (1,) * (codes.dim() - 1))
    planes = [torch.sum(((c >> p) & 1) << j, dim=1) for p in range(bits)]
    return _to_i32(torch.stack(planes, dim=1))


def unpack_bitplane(planes: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Inverse of :func:`pack_bitplane`: (K//32, bits, ...) -> (K, ...) uint8."""
    p32 = planes.to(torch.int32)
    j = torch.arange(PLANE_GROUP, dtype=torch.int32, device=planes.device).reshape(
        (1, PLANE_GROUP) + (1,) * (planes.dim() - 2))
    code = torch.zeros((planes.shape[0], PLANE_GROUP) + tuple(planes.shape[2:]),
                       dtype=torch.int32, device=planes.device)
    for p in range(bits):
        code |= ((p32[:, p][:, None] >> j) & 1) << p
    return code.reshape((planes.shape[0] * PLANE_GROUP,) + tuple(planes.shape[2:])).to(
        torch.uint8)


# --------------------------------------------------------------------------
# Plane-major (streaming) layout
# --------------------------------------------------------------------------
def plane_major(planes: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """(K//32, bits, ...) interleaved -> (bits, K//32, ...) MSB-first."""
    return torch.flip(torch.movedim(planes, 1, 0), dims=(0,))


def plane_interleaved(pm: torch.Tensor, bits: int = 3) -> torch.Tensor:
    """Inverse of :func:`plane_major`."""
    return torch.movedim(torch.flip(pm, dims=(0,)), 0, 1)


def unpack_bitplane_major(pm: torch.Tensor, bits: int = 3,
                          n_planes: int | None = None) -> torch.Tensor:
    """(P, K//32, ...) MSB-first plane-major words -> (K, ...) uint8 codes.

    Only the leading ``n_planes`` planes are read (default: all present);
    missing trailing planes contribute zero bits.
    """
    np_ = pm.shape[0] if n_planes is None else n_planes
    p32 = pm.to(torch.int32)
    j = torch.arange(PLANE_GROUP, dtype=torch.int32, device=pm.device).reshape(
        (1, PLANE_GROUP) + (1,) * (pm.dim() - 2))
    code = torch.zeros((pm.shape[1], PLANE_GROUP) + tuple(pm.shape[2:]),
                       dtype=torch.int32, device=pm.device)
    for p in range(np_):
        code |= ((p32[p][:, None] >> j) & 1) << (bits - 1 - p)
    return code.reshape((pm.shape[1] * PLANE_GROUP,) + tuple(pm.shape[2:])).to(torch.uint8)


# --------------------------------------------------------------------------
# Per-plane integrity (degraded-wire serving)
# --------------------------------------------------------------------------
def plane_crcs(codes, bits: int = 3) -> tuple[int, ...]:
    """Per-bit-plane CRC32s of a code tensor, MSB FIRST (host-side).

    CRCs run over the packed bit rows, so they are layout independent and
    equal to the JAX package's for the same codes.
    """
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    c = np.asarray(codes, dtype=np.uint8).reshape(-1)
    out = []
    for p in range(bits - 1, -1, -1):  # MSB first
        row = np.packbits((c >> p) & np.uint8(1))
        out.append(zlib.crc32(row.tobytes()) & 0xFFFFFFFF)
    return tuple(out)



# --------------------------------------------------------------------------
# Wire-format byte accounting (drives the Eq. 11/12 energy model)
# --------------------------------------------------------------------------
def wire_bytes(n_codes: int, n_scales: int, bits: int = 3, scalar_bits: int = 32) -> int:
    """Bytes on the channel for a packed tensor: codes + full-precision scalars."""
    return 4 * dense_words(n_codes, bits) + (scalar_bits // 8) * n_scales
