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

A step replayed from a CUDA graph runs no Python, so no call counts.
The engine records, with :func:`record_counts`, what a step's calls add
to :data:`counters`, :data:`traffic`, ``kernels.qsq.launches`` and
``kernels.qsq.work`` while it is captured (the capture launches nothing, so nothing stays counted),
and :func:`add_counts` adds that on every replay, phase words under the
replay's own :func:`dispatch_phase` label: the counts stay per call.

Inside :func:`verify_row_blocks` a call of more than
:data:`~repro_torch.kernels.qsq.SAME_PLAN_ROWS` rows runs as several
launches of at most that many rows each (the speculative verify, so each
launch keeps the GEMV's split of K).  The counters still count the one logical call;
``traffic["row_block_extra_plane_words"]`` adds the plane words the extra
launches read again, and ``kernels.qsq.launches`` counts every launch.
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
# most rows one launch may take (0 = any), set only through verify_row_blocks()
_block_rows: int = 0

__all__ = ["GEMV_M_MAX", "MASK_VARIANTS", "Plan", "add_counts", "counters", "dispatch_phase",
           "packed_matmul", "plan", "record_counts", "reset_counters", "traffic",
           "verify_row_blocks"]


def reset_counters() -> None:
    counters.clear()
    traffic.clear()


def _all_counters() -> tuple[collections.Counter, ...]:
    return counters, traffic, qsq.launches, qsq.work


@contextlib.contextmanager
def record_counts():
    """Count nothing inside the block: the yielded list receives, on exit,
    what the block's calls would have added to (:data:`counters`,
    :data:`traffic`, ``qsq.launches``, ``qsq.work``), phase words left
    out.  The engine records a step's capture (or warm-up) with it."""
    global _phase
    before = [collections.Counter(c) for c in _all_counters()]
    prev, _phase = _phase, ""
    delta: list[collections.Counter] = []
    try:
        yield delta
    finally:
        _phase = prev
        for c, b in zip(_all_counters(), before, strict=True):
            delta.append(c - b)
            c.clear()
            c.update(b)


def add_counts(delta: list[collections.Counter]) -> None:
    """Add a recorded step's counts, as its calls would have on a run:
    inside :func:`dispatch_phase` its plane words also under the phase."""
    for c, d in zip(_all_counters(), delta, strict=True):
        c.update(d)
    if _phase:
        t = delta[1]
        traffic[f"phase:{_phase}:plane_words_read"] += t["plane_words_read"]
        traffic[f"phase:{_phase}:plane_words_full"] += t["plane_words_full"]


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


@contextlib.contextmanager
def verify_row_blocks():
    """Run every packed matmul inside the block in launches of at most
    ``SAME_PLAN_ROWS`` rows (a multiple of 16, so every 16-row tile keeps
    its rows and a masked launch keeps one variant a tile): ``lm_verify``
    runs in it so each launch takes the GEMV's split."""
    global _block_rows
    prev = _block_rows
    _block_rows = qsq.SAME_PLAN_ROWS
    try:
        yield
    finally:
        _block_rows = prev


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
        masked = qsq.qsq_matvec_masked if p.route == ROUTE_GEMV else qsq.qsq_matmul_masked
        plane_mask = plane_mask.to(torch.int32)

        def launch(lo: int, hi: int) -> torch.Tensor:
            return masked(x[lo:hi], plane_mask[lo:hi], planes, scales, **kw)
    else:
        plain = qsq.qsq_matvec if p.route == ROUTE_GEMV else qsq.qsq_matmul

        def launch(lo: int, hi: int) -> torch.Tensor:
            return plain(x[lo:hi], planes, scales, **kw)
    r = _block_rows or m
    if m <= r:
        return launch(0, m)
    n_blocks = -(-m // r)
    traffic["row_block_extra_plane_words"] += (n_blocks - 1) * n_read * words
    return torch.cat([launch(i, i + r) for i in range(0, m, r)])
