"""Eq. 11/12 memory + DRAM-energy model, with roofline terms for the H100
(the port of ``repro/core/energy.py``).

The paper's energy model is a bandwidth model: energy = bits moved from DRAM
x energy-per-bit (6400 pJ per 32-bit DRAM access, after [Yang et al. CVPR'17]).
On a GPU the same quantity (bytes moved from HBM) is the numerator of the
roofline *memory term*, so this module serves both the paper's Eq. 11/12
accounting and roofline bounds.  The Eq. 11/12 functions are integer and
Python-float arithmetic, equal bit for bit to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# Paper constants
DRAM_PJ_PER_32B_ACCESS = 6400.0  # pJ to move 32 bits from DRAM (Fig. 1, [8])
FPB = 32  # Full Precision Bits

# NVIDIA H100 80GB HBM3 (SXM) data-sheet figures, at its 700 W power limit
H100_PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
H100_HBM_BW = 3.35e12  # HBM3, bytes/s
H100_NVLINK_BW = 450e9  # NVLink 4, bytes/s per direction


def nbits_unquantized(numel: int, fpb: int = FPB) -> int:
    """Eq. 11: bits to store a full-precision tensor."""
    return fpb * numel


def nbits_quantized(
    numel: int, group_size: int, bit_encoding: int = 3, fpb: int = FPB
) -> int:
    """Eq. 12 generalized: BE bits per element + one fpb scalar per group."""
    n_scalars = numel // group_size
    return bit_encoding * numel + fpb * n_scalars


def nbits_conv_layer(
    h: int, w: int, c: int, num: int, group_size: int | None = None,
    bit_encoding: int = 3, fpb: int = FPB,
) -> int:
    """Eq. 11/12 verbatim for a conv layer (H, W, C, Num filters).

    The paper's Eq. 12 forms vectors across the ``Num`` filters at each
    (h, w, c) position, i.e. group_size == Num, giving H*W*C scalars.  Pass
    group_size=None for that faithful reading.
    """
    numel = h * w * c * num
    if group_size is None:
        return bit_encoding * numel + h * w * c * fpb
    return nbits_quantized(numel, group_size, bit_encoding, fpb)


def memory_savings(numel: int, group_size: int, bit_encoding: int = 3) -> float:
    """Fractional model-size reduction, 1 - quantized/full (paper: 82.49%)."""
    return 1.0 - nbits_quantized(numel, group_size, bit_encoding) / nbits_unquantized(numel)


def dram_energy_pj(nbits: int) -> float:
    """DRAM transfer energy for nbits (paper's 6400 pJ / 32-bit model)."""
    return (nbits / 32.0) * DRAM_PJ_PER_32B_ACCESS


def energy_savings(numel: int, group_size: int, bit_encoding: int = 3) -> float:
    """Fractional DRAM-energy saving (paper: 88.82% @3b, 91.95% @2b ConvNet)."""
    full = dram_energy_pj(nbits_unquantized(numel))
    q = dram_energy_pj(nbits_quantized(numel, group_size, bit_encoding))
    return 1.0 - q / full


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One conv/dense layer for the Eq. 11/12 sweeps."""

    name: str
    h: int
    w: int
    c: int
    num: int

    @property
    def numel(self) -> int:
        return self.h * self.w * self.c * self.num


def model_savings(
    layers: Sequence[LayerShape], group_size: int, bit_encoding: int = 3
) -> dict:
    """Aggregate Eq. 11/12 over a model's layers (Fig. 9 reproduction)."""
    full_bits = sum(nbits_unquantized(ls.numel) for ls in layers)
    q_bits = sum(nbits_quantized(ls.numel, group_size, bit_encoding) for ls in layers)
    return {
        "full_bits": full_bits,
        "quantized_bits": q_bits,
        "memory_savings": 1.0 - q_bits / full_bits,
        "energy_savings": 1.0 - dram_energy_pj(q_bits) / dram_energy_pj(full_bits),
        "full_dram_pj": dram_energy_pj(full_bits),
        "quantized_dram_pj": dram_energy_pj(q_bits),
    }


# --------------------------------------------------------------------------
# Roofline terms
# --------------------------------------------------------------------------
def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    n_chips: int,
    peak_flops: float = H100_PEAK_BF16_FLOPS,
    hbm_bw: float = H100_HBM_BW,
    link_bw: float = H100_NVLINK_BW,
) -> dict:
    """The three roofline terms in seconds + the dominant bottleneck."""
    compute_s = flops / (n_chips * peak_flops)
    memory_s = hbm_bytes / (n_chips * hbm_bw)
    collective_s = collective_bytes / (n_chips * link_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
    }
