"""Deterministic fault injection for overload-graceful serving (a copy of
the JAX package's ``serve/faults.py``, owned by the port, with the port's
codec for the wire).

The paper's deployment story is hostile by construction: a 3-bit
artifact shipped over a lossy channel to an edge device that is
bandwidth-starved and bursty.  This module makes those conditions
reproducible — every injector is seeded and host-side, so the robustness
tests and the ``bench_serve`` overload sweep replay EXACTLY the same
degradation every run:

* **wire damage** — :func:`corrupt_plane_npz` flips bits inside one
  bit-plane of a saved artifact's packed codes (checksum verification at
  ``EdgeArtifact.load`` must cap the tier ceiling, or hard-error on the
  sign/MSB plane); :func:`truncate_planes_npz` zeroes trailing LSB
  planes of every leaf — the partial plane-major download, which under
  MSB-first streaming is *literally* a lower quality tier;
* **overload** — :func:`poisson_trace` / :func:`overload_trace` /
  :func:`burst_trace` build arrival traces in cost-clock units for
  :func:`replay`;
* **stragglers** — :func:`slow_ticks` injects periodic stalls through
  ``ServeEngine.advance_clock`` (deadlines keep aging while the engine
  loses a tick);
* **bad input** — :func:`oversized_prompt` builds a prompt the stream
  can never serve (must die as a typed ``SubmitRejected``, not a hang).

:func:`replay` is the harness: it drives one engine through an arrival
trace on the engine's own cost clock (idle gaps advance the clock, busy
periods let dispatch costs advance it) and returns a
:class:`ReplayReport` with the overload scorecard — p50/p90 latency,
shed/timeout/reject rates, realized quality mix, peak queue depth.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.quant.artifact import atomic_savez
from repro_torch.quant.store import plane_mask_for_drop

__all__ = [
    "ReplayReport",
    "burst_trace",
    "corrupt_plane_npz",
    "overload_trace",
    "oversized_prompt",
    "poisson_trace",
    "replay",
    "slow_ticks",
    "truncate_planes_npz",
]


# --------------------------------------------------------------------------
# Wire damage (operates on saved EdgeArtifact npz files)
# --------------------------------------------------------------------------
def _packed_keys(files, leaf: str | None) -> list[str]:
    keys = sorted(k for k in files if k.endswith("['packed']")
                  and (leaf is None or leaf in k))
    if not keys:
        raise KeyError(
            f"no packed wire leaf matching {leaf!r} in the artifact")
    return keys


def _load_flat(path) -> dict:
    with np.load(Path(path), allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _leaf_numel(flat: dict, packed_key: str) -> int:
    """Element count of the codes a packed leaf holds, from its sibling
    ``shape`` entry — stored either whole (``...['shape']``) or flattened
    per-dimension (``...['shape'][0]``, ``...['shape'][1]``, ...)."""
    stem = packed_key[: -len("['packed']")] + "['shape']"
    if stem in flat:
        return int(np.prod(np.asarray(flat[stem]).reshape(-1)))
    dims = [int(flat[k]) for k in sorted(flat) if k.startswith(stem + "[")]
    if not dims:
        raise KeyError(f"no shape entry for packed leaf {packed_key!r}")
    return int(np.prod(dims))


def _unpack(words: np.ndarray, n: int) -> np.ndarray:
    """Dense-packed 3-bit wire words -> a writable (n,) uint8 code array."""
    return codec.unpack_dense(torch.from_numpy(np.array(words, np.int32)), n).numpy().copy()


def _pack(codes: np.ndarray) -> np.ndarray:
    return codec.pack_dense(torch.from_numpy(codes), bits=3).numpy()


def _save_flat(flat: dict, path) -> Path:
    return atomic_savez(flat, Path(path))


def corrupt_plane_npz(path, plane: int, leaf: str | None = None,
                      n_flips: int = 4, seed: int = 0,
                      out=None) -> Path:
    """Flip ``n_flips`` bits inside ONE bit-plane of one packed wire leaf.

    ``plane`` indexes MSB-first like the artifact's per-plane checksums:
    0 is the sign/MSB plane (corruption there is unrecoverable — load
    must raise), 2 is the trailing LSB plane (recoverable — load caps
    the tier ceiling).  ``leaf`` picks the first packed leaf whose npz
    key contains the substring (None: the first leaf).  Deterministic in
    ``seed``; writes to ``out`` (default: in place) and returns the path.
    """
    if not 0 <= plane < 3:
        raise ValueError(f"plane must be 0 (MSB) .. 2 (LSB), got {plane}")
    flat = _load_flat(path)
    key = _packed_keys(flat, leaf)[0]
    n = _leaf_numel(flat, key)
    codes = _unpack(flat[key], n)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(int(n_flips), n), replace=False)
    codes[idx] ^= np.uint8(1 << (2 - plane))  # MSB-first index -> bit pos
    flat[key] = _pack(codes)
    return _save_flat(flat, out if out is not None else path)


def truncate_planes_npz(path, drop: int = 1, leaves=None, out=None) -> Path:
    """Zero the trailing ``drop`` LSB plane(s) of packed wire leaves —
    the artifact a receiver holds after a partial MSB-first plane-major
    download (missing planes read as zero bits).  ``leaves`` restricts
    the truncation to the named '/'-joined paths (a tier's ``drop_map``
    keys: under demand-driven streaming the tier ladder IS the download
    deferral schedule — only tier-deferrable planes arrive last); None
    truncates every leaf, which only a ladder truncating everything can
    absorb.  The result must load as a tier-capped artifact
    bit-identical to a checksum-repaired corrupted one."""
    flat = _load_flat(path)
    mask = np.uint8(plane_mask_for_drop(drop))
    wanted = None if leaves is None else {
        "".join(f"['{seg}']" for seg in p.split("/")) + "['packed']"
        for p in leaves
    }
    for key in _packed_keys(flat, None):
        if wanted is not None and key not in wanted:
            continue
        n = _leaf_numel(flat, key)
        flat[key] = _pack(_unpack(flat[key], n) & mask)
    return _save_flat(flat, out if out is not None else path)


# --------------------------------------------------------------------------
# Arrival traces / stragglers / bad input
# --------------------------------------------------------------------------
def poisson_trace(n: int, mean_gap: float, seed: int = 0) -> list[float]:
    """``n`` Poisson-process arrival times (cost-clock units): exponential
    inter-arrival gaps with the given mean, deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(mean_gap, size=n)).tolist()


def overload_trace(arrivals, factor: float) -> list[float]:
    """Compress a trace in time by ``factor`` — the same requests arriving
    ``factor``x faster (factor 1.0 is the trace unchanged)."""
    return [float(a) / float(factor) for a in arrivals]


def burst_trace(n: int, at: float = 0.0) -> list[float]:
    """``n`` simultaneous arrivals — the worst-case thundering herd."""
    return [float(at)] * n


def slow_ticks(every: int, stall: float):
    """Periodic straggler injector for :func:`replay`: every ``every``-th
    engine tick loses ``stall`` extra cost-clock units (host pause, GC,
    preemption) — deadlines keep aging through the stall."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")

    def extra(tick: int) -> float:
        return float(stall) if (tick + 1) % every == 0 else 0.0

    return extra


def oversized_prompt(engine) -> list[int]:
    """A prompt one token wider than the engine's fixed prefill window —
    must be refused at submit with a typed SubmitRejected, never queued."""
    return [1] * (engine.cfg.max_prompt + 1)


# --------------------------------------------------------------------------
# Replay harness
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ReplayReport:
    """The overload scorecard of one :func:`replay` run.

    ``statuses`` maps rid -> terminal RequestStatus; ``arrivals`` maps
    rid -> the TRACE arrival time (latencies are measured from it, so
    queueing delay during busy periods is charged to the request).
    Latency pools include every request that was actually taken on
    (DONE, and TIMED_OUT/CANCELLED at their eviction time); SHED and
    REJECTED requests never consumed service and are scored by their
    rates instead."""

    statuses: dict
    arrivals: dict
    ticks: int
    makespan: float
    max_queue_depth: int

    def latencies(self) -> list[float]:
        out = []
        for rid, st in self.statuses.items():
            if st.finish_reason is not None and st.finish_reason.value in (
                    "done", "timed_out", "cancelled"):
                out.append(st.finished_t - self.arrivals[rid])
        return out

    def rate(self, reason: str) -> float:
        n = sum(1 for st in self.statuses.values()
                if st.finish_reason is not None
                and st.finish_reason.value == reason)
        return n / max(len(self.statuses), 1)

    def quality_mix(self) -> dict[str, int]:
        """Realized tiers of requests that were actually admitted."""
        mix: dict[str, int] = {}
        for st in self.statuses.values():
            if st.admitted is not None:
                mix[st.quality or "default"] = mix.get(st.quality or "default", 0) + 1
        return mix

    def summary(self) -> dict:
        lat = self.latencies()
        return {
            "n": len(self.statuses),
            "p50_latency": round(float(np.percentile(lat, 50)), 3) if lat else 0.0,
            "p90_latency": round(float(np.percentile(lat, 90)), 3) if lat else 0.0,
            "mean_latency": round(float(np.mean(lat)), 3) if lat else 0.0,
            "done_rate": round(self.rate("done"), 3),
            "timeout_rate": round(self.rate("timed_out"), 3),
            "shed_rate": round(self.rate("shed"), 3),
            "reject_rate": round(self.rate("rejected"), 3),
            "quality_mix": self.quality_mix(),
            "max_queue_depth": self.max_queue_depth,
            "ticks": self.ticks,
            "makespan": round(float(self.makespan), 3),
        }


def replay(engine, prompts, arrivals, max_new: int = 8, qualities=None,
           deadline: float | None = None, slow=None,
           max_ticks: int = 50_000) -> ReplayReport:
    """Drive ``engine`` through an arrival trace on its own cost clock.

    Each prompt is submitted the moment the engine clock reaches its
    arrival time; idle gaps are skipped by ``advance_clock`` (deadlines
    still age), busy periods advance the clock through dispatch costs.
    ``deadline`` is the per-request relative budget; ``slow`` an optional
    :func:`slow_ticks`-style injector.  Deterministic: same engine +
    trace => same report."""
    if qualities is None:
        qualities = [None] * len(prompts)
    elif isinstance(qualities, str):
        qualities = [qualities] * len(prompts)
    order = np.argsort(np.asarray(arrivals), kind="stable")
    rids: dict[int, int] = {}
    arr_t: dict[int, float] = {}
    i = 0
    ticks = 0
    max_depth = 0
    while True:
        while i < len(order) and arrivals[order[i]] <= engine.now + 1e-9:
            j = int(order[i])
            rid = engine.submit(prompts[j], max_new=max_new,
                                quality=qualities[j], deadline=deadline)
            rids[rid] = j
            arr_t[rid] = float(arrivals[j])
            i += 1
        max_depth = max(max_depth, engine.queue_depth)
        if not engine.has_work:
            if i >= len(order):
                break
            # idle until the next arrival: jump the clock, don't spin
            engine.advance_clock(float(arrivals[order[i]]) - engine.now)
            continue
        engine.step()
        if slow is not None:
            extra = slow(ticks)
            if extra:
                engine.advance_clock(extra)
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(
                f"replay watchdog: {ticks} ticks without draining "
                f"({engine.queue_depth} queued)")
    return ReplayReport(
        statuses={rid: engine.poll(rid) for rid in rids},
        arrivals=arr_t, ticks=ticks, makespan=engine.now,
        max_queue_depth=max_depth,
    )
