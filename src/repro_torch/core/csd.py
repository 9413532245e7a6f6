"""Canonic Signed Digit (CSD) arithmetic, the paper's Quality Scalable
Multiplier, as plain tensor functions (the port of ``repro/core/csd.py``).

The paper's approximate multiplier recodes the multiplicand into CSD form
(digits in {-1, 0, +1}, no two adjacent non-zeros: the fewest non-zero
digits) and truncates the least-significant non-zero digits to cut partial
products.  A tensor-core matmul cannot skip partial products, but the
numerics carry over: multiplying by a k-digit-truncated CSD weight is
exactly multiplying by ``csd_round(w, k)``.  So CSD is a weight rounding
mode here, and :func:`csd_nonzero_histogram` reproduces the Fig. 11
statistic.

The greedy nearest-signed-power-of-two residual expansion below is the
classic CSD recoding: each step takes the residual's nearest signed power
of two, most significant first; stopping after k steps truncates the
k+1-th and later partial products.

The digit count works in int64 (torch's uint32 has few kernels): with
``total_bits <= 30`` every intermediate fits in 32 bits, so the counts
equal the JAX package's uint32 arithmetic exactly.
"""
from __future__ import annotations

import torch


def csd_round(w: torch.Tensor, max_digits: int = 3, min_exp: int = -16,
              max_exp: int = 15) -> torch.Tensor:
    """Round to the nearest value with <= max_digits non-zero CSD digits.

    Exponents are clamped to [min_exp, max_exp] (a 32-bit fixed-point-like
    range by default, matching the paper's MATLAB ``fi`` analysis).
    """
    residual = w.to(torch.float32)
    approx = torch.zeros_like(residual)
    for _ in range(max_digits):
        a = torch.abs(residual)
        # nearest power of two: exponent = floor(log2(|r| * 4/3)); the 4/3
        # factor puts the rounding boundary at 1.5 * 2^e
        safe = torch.where(a > 0, a, torch.ones_like(a))
        e = torch.clamp(torch.floor(torch.log2(safe * (4.0 / 3.0))), min_exp, max_exp)
        term = torch.sign(residual) * torch.exp2(e)
        term = torch.where(a > 2.0 ** (min_exp - 1), term, torch.zeros_like(term))
        approx = approx + term
        residual = residual - term
    return approx


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2^32), SWAR in int64 -> int32."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def csd_digit_count(w: torch.Tensor, frac_bits: int = 16,
                    total_bits: int = 30) -> torch.Tensor:
    """Number of non-zero CSD digits of each weight at fixed-point precision.

    Reproduces the Fig. 11 statistic: quantize w to ``total_bits`` fixed
    point with ``frac_bits`` fractional bits, then count the non-zero digits
    of the canonical signed-digit recoding (NAF) of the integer:
    ``h = u + (u >> 1)``, ``nonzeros = popcount(h ^ (u >> 1))``.
    """
    if total_bits > 30:
        raise ValueError(f"total_bits must be <= 30, got {total_bits}")
    x = torch.round(w.to(torch.float32) * float(2 ** frac_bits))
    lim = 2 ** (total_bits - 1) - 1
    u = torch.abs(torch.clamp(x.to(torch.float64), -lim, lim).to(torch.int64))
    return _popcount32((u + (u >> 1)) ^ (u >> 1))


def csd_nonzero_histogram(w: torch.Tensor, frac_bits: int = 16,
                          max_count: int = 33) -> torch.Tensor:
    """Histogram of non-zero CSD digit counts (Fig. 11), int32 (max_count,)."""
    counts = csd_digit_count(w.reshape(-1), frac_bits=frac_bits).to(torch.int64)
    return torch.bincount(counts, minlength=max_count)[:max_count].to(torch.int32)


def partial_product_savings(w: torch.Tensor, max_digits: int,
                            frac_bits: int = 16) -> torch.Tensor:
    """Fraction of partial products an approximate CSD multiplier would skip.

    Exact multiplier cost model: one partial product per non-zero CSD digit;
    the quality-scalable multiplier caps digits at ``max_digits``.
    """
    counts = csd_digit_count(w.reshape(-1), frac_bits=frac_bits).to(torch.float32)
    exact = torch.sum(counts)
    kept = torch.sum(torch.clamp(counts, max=float(max_digits)))
    return torch.where(exact > 0, 1.0 - kept / exact, torch.zeros_like(exact))
