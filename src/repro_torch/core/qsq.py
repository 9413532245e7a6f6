"""Quality Scalable Quantization (QSQ): the port of ``repro/core/qsq.py``.

Eq. 5-10 of the paper: weights split into groups of N along the
contraction axis, one full-precision scalar per group
``alpha = sum(|w|) / (phi * N)`` (Eq. 9), one level per element from the
power-of-two alphabet ``{0, +-1, +-2, +-4}`` capped by the quality knob
phi, and ``w_hat = alpha * beta``.  Everything is plain PyTorch on the
caller's device.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

# Table II of the paper: 3-bit code -> quantization level (7 is unused).
LEVEL_TABLE = np.array([0, 1, 2, 4, -1, -2, -4, 0], dtype=np.int8)
# Sign-magnitude recode (wire v2): bit 2 is the sign, bits 1..0 the
# magnitude index (0->0, 1->1, 2->2, 3->4).  Code 4 (-0) is unused.
SM_LEVEL_TABLE = np.array([0, 1, 2, 4, 0, -1, -2, -4], dtype=np.int8)

AssignMode = Literal["sigma", "nearest"]


def theta_levels(phi: int) -> int:
    """Eq. 8: number of non-negative magnitude levels for quality knob phi."""
    if phi not in (1, 2, 4):
        raise ValueError(f"phi must be one of 1, 2, 4; got {phi}")
    return int(np.ceil(np.log2(2 * (1 + np.log2(phi))))) + 1


def bits_per_code(phi: int) -> int:
    """Wire bits per weight: 3 for phi in {2, 4}; 2 for the ternary phi=1."""
    theta_levels(phi)  # validate
    return 2 if phi == 1 else 3


@dataclasses.dataclass(frozen=True)
class QSQConfig:
    """Quantizer hyper-parameters (see the JAX package's ``QSQConfig``)."""

    phi: int = 4
    group_size: int = 16
    assign: AssignMode = "nearest"
    delta: float = 2.0
    gamma_frac: float = 0.5
    refit_alpha: bool = False

    def __post_init__(self):
        theta_levels(self.phi)  # validate
        if self.group_size < 1:
            raise ValueError("group_size must be >= 1")

    @property
    def max_level(self) -> int:
        return int(2 ** (theta_levels(self.phi) - 2)) if self.phi > 1 else 1

    @property
    def bits_per_code(self) -> int:
        return bits_per_code(self.phi)


@dataclasses.dataclass
class QSQTensor:
    """Signed levels (int8, grouped along axis 0) + per-group f32 scalars."""

    levels: torch.Tensor
    scales: torch.Tensor
    group_size: int
    phi: int
    conv_shape: tuple | None = None


def _table(table: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.int8, device=device)


def levels_to_codes(levels: torch.Tensor) -> torch.Tensor:
    """Signed levels {0,+-1,+-2,+-4} -> Table II 3-bit codes."""
    mag = torch.abs(levels.to(torch.int32))
    mag_idx = torch.where(mag == 4, 3, mag)
    return torch.where(levels < 0, mag_idx + 3, mag_idx).to(torch.uint8)


def codes_to_levels(codes: torch.Tensor) -> torch.Tensor:
    """Table II decode; code 7 -> 0 and stray high bits are dropped."""
    return _table(LEVEL_TABLE, codes.device)[codes.to(torch.int64) & 0x7]


def levels_to_smcodes(levels: torch.Tensor) -> torch.Tensor:
    """Signed levels -> sign-magnitude 3-bit codes."""
    mag = torch.abs(levels.to(torch.int32))
    mag_idx = torch.where(mag == 4, 3, mag)
    return (mag_idx + 4 * (levels < 0).to(torch.int32)).to(torch.uint8)


def smcodes_to_levels(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`levels_to_smcodes`; -0 (code 4) decodes to 0."""
    return _table(SM_LEVEL_TABLE, codes.device)[codes.to(torch.int64) & 0x7]


def _nearest_levels(wg, alpha_b, max_level):
    """argmin_beta |w - alpha*beta| over the signed power-of-two alphabet."""
    r = wg / alpha_b
    a = torch.abs(r)
    mag = torch.where(a < 0.5, 0, torch.where(a < 1.5, 1, torch.where(a < 3.0, 2, 4)))
    mag = torch.clamp(mag, max=max_level).to(torch.int8)
    return torch.where(r < 0, -mag, mag)


def _quantize_impl(w: torch.Tensor, *, phi: int, group_size: int, assign: str,
                   delta: float, gamma_frac: float, refit_alpha: bool = False,
                   axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize along ``axis`` (leading axes are independent stacks, as the
    JAX package vmaps them) -> (levels int8 like w, scales f32 with the
    grouped axis shortened to K // G)."""
    k = w.shape[axis]
    if k % group_size != 0:
        raise ValueError(f"leading dim {k} not divisible by group_size {group_size}")
    shape = tuple(w.shape)
    wg = w.to(torch.float32).reshape(shape[:axis] + (k // group_size, group_size)
                                     + shape[axis + 1:])
    gax = axis + 1  # the within-group axis

    alpha = torch.sum(torch.abs(wg), dim=gax) / (phi * group_size)  # Eq. 9
    safe_alpha = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    alpha_b = safe_alpha.unsqueeze(gax)
    max_level = 2 ** (theta_levels(phi) - 2) if phi > 1 else 1

    if assign == "nearest":
        levels = _nearest_levels(wg, alpha_b, max_level)
    elif assign == "sigma":
        pos_mask = wg > 0
        neg_mask = wg < 0
        eps = 1e-12
        zero = torch.zeros_like(wg)
        sig_p = torch.sqrt(torch.sum(torch.where(pos_mask, wg * wg, zero), dim=gax)
                           / (torch.sum(pos_mask, dim=gax) + eps)).unsqueeze(gax)
        sig_n = torch.sqrt(torch.sum(torch.where(neg_mask, wg * wg, zero), dim=gax)
                           / (torch.sum(neg_mask, dim=gax) + eps)).unsqueeze(gax)
        gamma = gamma_frac * alpha_b
        a = torch.abs(wg)
        sig = torch.where(wg >= 0, sig_p, sig_n)
        sig = torch.where(sig == 0, alpha_b.expand_as(sig), sig)
        mag = torch.where(a < gamma, 0, torch.where(a < sig, 1, torch.where(
            a < delta * sig, 2, 4)))
        mag = torch.clamp(mag, max=max_level).to(torch.int8)
        levels = torch.where(wg < 0, -mag, mag)
    else:
        raise ValueError(f"unknown assign mode {assign!r}")

    alpha_out = alpha
    if refit_alpha:
        # one Lloyd iteration, twice: least-squares alpha for the current
        # levels, then re-assign against it (same wire format)
        for _ in range(2):
            lev_f = levels.to(torch.float32)
            num = torch.sum(wg * lev_f, dim=gax)
            den = torch.sum(lev_f * lev_f, dim=gax)
            alpha_out = torch.where(den > 0, num / torch.clamp(den, min=1e-12), safe_alpha)
            alpha_out = torch.abs(alpha_out)
            safe2 = torch.where(alpha_out == 0, torch.ones_like(alpha_out), alpha_out)
            levels = _nearest_levels(wg, safe2.unsqueeze(gax), max_level)

    return levels.reshape(shape), alpha_out.to(torch.float32)


def quantize(w: torch.Tensor, cfg: QSQConfig) -> QSQTensor:
    """Quantize a tensor along its leading axis in groups of ``cfg.group_size``."""
    levels, scales = _quantize_impl(
        w, phi=cfg.phi, group_size=cfg.group_size, assign=cfg.assign,
        delta=cfg.delta, gamma_frac=cfg.gamma_frac, refit_alpha=cfg.refit_alpha)
    return QSQTensor(levels=levels, scales=scales, group_size=cfg.group_size, phi=cfg.phi)


def dequantize(q: QSQTensor, dtype=torch.float32) -> torch.Tensor:
    """w_hat = alpha * beta, groups along axis 0 (the inverse of :func:`quantize`)."""
    k = q.levels.shape[0]
    lev = q.levels.to(torch.float32).reshape(k // q.group_size, q.group_size,
                                             *q.levels.shape[1:])
    return (lev * q.scales.unsqueeze(1)).reshape(q.levels.shape).to(dtype)
