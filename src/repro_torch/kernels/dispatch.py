"""Shape-aware dispatch for the packed QSQ matmul (the port of
``repro/kernels/dispatch.py`` and ``repro/kernels/ops.py``).

Every ``PackedWeight.matmul`` lands in :func:`packed_matmul`, which routes
on M: at most :data:`GEMV_M_MAX` rows (decode: batch slots x one token)
go to the GEMV kernels, larger M (admission prefill) to the tiled GEMM
kernels; a per-row ``plane_mask`` selects the masked sibling of either.
The TPU's (8, 128) tile padding does not carry over: the CUDA kernels mask
ragged M and N themselves, so no operand is padded.

:data:`counters` and :data:`traffic` count PER CALL: every call of
:func:`packed_matmul` adds to them when it runs.  (The JAX package counts
at trace time — once per compiled program — so its counters stay frozen
across cached dispatches; the port runs eagerly and counts each one.)
Inside :func:`dispatch_phase` every call also adds its plane words under
``"phase:<label>:plane_words_read|full"``, per call as well.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from repro_torch.kernels import qsq
from repro_torch.kernels.ref import MASK_VARIANTS

PLANE = 32
GEMV_M_MAX = qsq.GEMV_M_MAX

ROUTE_GEMV = "gemv"
ROUTE_GEMM = "gemm"

# per-call route counters: route name and "<route>:masked"
counters: collections.Counter = collections.Counter()
# per-call plane-traffic accounting:
#   "<route>:planes<P>" — calls that streamed P of the 3 bit-planes
#   "plane_words_read"  — int32 plane words the routed kernel streams
#   "plane_words_full"  — words a full 3-plane stream would have read
#   "phase:<label>:plane_words_read|full" — the same, for calls made inside
#                         dispatch_phase(label)
traffic: collections.Counter = collections.Counter()

# serving-phase label for traffic attribution ("" = unlabeled), set only
# through dispatch_phase()
_phase: str = ""

__all__ = ["GEMV_M_MAX", "MASK_VARIANTS", "Plan", "counters", "dispatch_phase",
           "packed_matmul", "plan", "reset_counters", "traffic"]


def reset_counters() -> None:
    counters.clear()
    traffic.clear()


@contextlib.contextmanager
def dispatch_phase(label: str):
    """Attribute the plane traffic of every call inside the block to a
    serving phase: the engine wraps its speculative draft ticks and verify
    dispatches in ``dispatch_phase("draft")`` / ``dispatch_phase("verify")``."""
    global _phase
    prev = _phase
    _phase = str(label)
    try:
        yield
    finally:
        _phase = prev


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str
    m: int
    k: int
    n: int


def plan(m: int, k: int, n: int, g: int) -> Plan:
    """Resolve (M, K, N, G) to a route: GEMV at M <= 16, GEMM above."""
    if k % PLANE:
        raise ValueError(f"K={k} is not a multiple of the {PLANE}-code plane word")
    if k % g:
        raise ValueError(f"group_size={g} does not divide K={k}")
    return Plan(route=ROUTE_GEMV if m <= GEMV_M_MAX else ROUTE_GEMM, m=m, k=k, n=n)


def packed_matmul(x: torch.Tensor, planes: torch.Tensor, scales: torch.Tensor, *,
                  group_size: int, plane_mask: torch.Tensor | None = None,
                  sign_mag: bool = False, plane_major: bool = False,
                  demand_drop: int = 0) -> torch.Tensor:
    """x (M, K) @ decode(planes, scales) -> (M, N) f32.

    ``plane_mask`` (M,) int32 makes the matmul quality-tiered per row: row
    m contracts against the weight decoded under its own mask, bit-identical
    to the unmasked kernel on ``truncate(drop_m)`` planes.  ``demand_drop``
    (0..2) is the batch demand floor: every live row drops at least that
    many planes, so only ``3 - demand_drop`` planes are read on plane-major
    input and only ``MASK_VARIANTS[demand_drop:]`` are decoded; a row
    demanding a pruned variant reads as zeros.
    """
    m, k = x.shape
    n = planes.shape[-1]
    if not 0 <= demand_drop < 3:
        raise ValueError(f"demand_drop must be 0..2, got {demand_drop}")
    if plane_mask is None and not plane_major:
        demand_drop = 0  # interleaved unmasked has nothing to prune
    p = plan(m, k, n, group_size)
    counters[p.route] += 1
    n_read = 3 - demand_drop if plane_major else 3
    words = k // PLANE * n
    traffic[f"{p.route}:planes{n_read}"] += 1
    traffic["plane_words_read"] += n_read * words
    traffic["plane_words_full"] += 3 * words
    if _phase:
        traffic[f"phase:{_phase}:plane_words_read"] += n_read * words
        traffic[f"phase:{_phase}:plane_words_full"] += 3 * words
    kw = dict(group_size=group_size, sign_mag=sign_mag, plane_major=plane_major,
              demand_drop=demand_drop)
    if plane_mask is not None:
        counters[f"{p.route}:masked"] += 1
        fn = qsq.qsq_matvec_masked if p.route == ROUTE_GEMV else qsq.qsq_matmul_masked
        return fn(x, plane_mask.to(torch.int32), planes, scales, **kw)
    fn = qsq.qsq_matvec if p.route == ROUTE_GEMV else qsq.qsq_matmul
    return fn(x, planes, scales, **kw)
