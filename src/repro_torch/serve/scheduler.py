"""Request-level continuous batching: the admit/evict loop over slots.

The paper's 3-bit artifacts only pay off when the dialed-down hardware is
kept busy: a static batch ties every slot to the slowest request, so a
new prompt waits for the whole batch to drain before its first token.
This module is the host-side half of the fix — pure bookkeeping, no tensors (a copy of the JAX
package's module, owned by the port):

* :class:`Request` — one submitted prompt with its arrival/admission/
  finish step indices, cost-clock timestamps, deadline, and the tokens
  emitted so far;
* :class:`Scheduler` — a BOUNDED admission queue plus a per-slot state
  machine ``FREE -> PREFILLING -> DECODING -> DONE (-> FREE)``.

The device half lives in :class:`~repro_torch.serve.engine.ServeEngine`: each
``engine.step()`` first admits queued requests into FREE slots (one
single-slot prefill + cache lane insert per admission)
and then runs ONE fixed-width decode iteration over all lanes, with the
per-slot ``active`` mask making finished/empty slots dead lanes instead
of shape changes.  A request that reaches ``max_new`` goes DONE and is
evicted in the same step, freeing its slot for the next admission —
batch mates never flush.

Overload-graceful serving adds TYPED terminations: every request ends
with a :class:`FinishReason` (``DONE`` / ``TIMED_OUT`` / ``CANCELLED`` /
``SHED`` / ``REJECTED``) and :meth:`Scheduler.poll` hands back a
structured :class:`RequestStatus` instead of an ambiguous ``None``.
Deadline expiry and caller cancellation EVICT mid-decode — an
active-mask flip on the engine side, never a retrace — keeping any
tokens already emitted as a partial result.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Iterator, Sequence


def plane_demand(live_tiers, default: int = 0) -> int:
    """Batch plane-demand floor for one decode tick.

    ``live_tiers`` are the quality-tier indices of the slots that will be
    live lanes in the dispatch (lower index = higher quality = more
    bit-planes kept).  The floor is their minimum: the batch must stream
    every plane its most-demanding live slot keeps, and nothing more — the
    OR of the live slots' plane masks collapses to the min tier index
    because each packed leaf turns it into a per-leaf drop via a suffix
    min over its tier-drop vector (``PackedWeight.demand_drop``), which
    never under-reads a live tier even when a leaf's drops are
    non-monotone.  The engine passes the result as a Python int, so the
    kernels see at most one specialisation per tier rather than
    2^planes.  With no live slots there is nothing
    to stream; ``default`` keeps the return a valid dispatch key."""
    tiers = [int(t) for t in live_tiers]
    return min(tiers) if tiers else int(default)


class SlotState(enum.Enum):
    FREE = "free"            # no request; a dead lane in the decode program
    PREFILLING = "prefilling"  # admission in flight: prompt -> cache lane
    DECODING = "decoding"    # live lane: one token per engine.step()
    DONE = "done"            # reached max_new; evicted before step() returns


class FinishReason(enum.Enum):
    """Why a request terminated — every request ends with exactly one.

    ``DONE`` is the only success; the rest are the overload/robustness
    outcomes: ``TIMED_OUT`` (deadline passed, queued or mid-decode, any
    tokens already emitted are kept as a partial result), ``CANCELLED``
    (caller-initiated :meth:`Scheduler.cancel`, likewise partial),
    ``SHED`` (the admission policy found that even the lowest quality
    tier cannot meet the SLO budget) and ``REJECTED`` (a structural
    refusal — bounded queue full, or an admission-policy queue cap)."""

    DONE = "done"
    TIMED_OUT = "timed_out"
    CANCELLED = "cancelled"
    SHED = "shed"
    REJECTED = "rejected"


class SubmitRejected(ValueError):
    """Typed submit-time rejection: the request could NEVER be served by
    this stream (oversized prompt, cache overflow, invalid deadline) —
    raised instead of queueing work that would hang the drain loop."""


class QueueFullError(SubmitRejected):
    """The scheduler's bounded queue is at ``max_queue``."""


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Per-request self-speculative decoding knobs.

    ``draft_tier`` names the quality tier the engine drafts at — a plane
    mask over the SAME packed weights, so the draft model is free (no
    second parameter tree, no extra HBM residency); it must sit strictly
    BELOW the request's serving tier on the ladder or there is nothing to
    save.  ``k`` is the draft window: tokens proposed per round before
    one batched verify dispatch at the serving tier accepts the longest
    agreeing prefix.  Outputs are token-identical to plain decode at the
    serving tier either way — speculation only changes which dispatches
    produced them."""

    draft_tier: str
    k: int = 4


@dataclasses.dataclass(frozen=True)
class RequestStatus:
    """One poll's view of a request — never ``None``, never ambiguous.

    ``state`` is ``queued`` / ``prefilling`` / ``decoding`` / ``done``;
    ``finish_reason`` is set exactly when ``state == "done"``.
    ``tokens`` carries the emitted ids once terminal (a PARTIAL list for
    ``TIMED_OUT`` / ``CANCELLED`` evictions, empty for ``SHED`` /
    ``REJECTED``) and ``None`` while the request is still in flight;
    ``n_tokens`` tracks live progress either way.  Step-index times
    (``arrival``/``admitted``/``finished``) count engine iterations; the
    ``*_t`` twins are on the engine's weight-stream cost clock (a
    full-quality dispatch costs 1.0, a demand-shortened one its
    read fraction), which is also the clock deadlines are enforced on."""

    rid: int
    state: str
    finish_reason: FinishReason | None
    tokens: list[int] | None
    n_tokens: int
    quality: str | None
    requested: str | None
    arrival: int
    admitted: int | None
    finished: int | None
    arrival_t: float
    admitted_t: float | None
    finished_t: float | None
    deadline: float | None
    detail: str = ""
    drafted: int = 0   # draft-tier tokens proposed for this request
    accepted: int = 0  # of those, accepted by a verify dispatch

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def ok(self) -> bool:
        return self.finish_reason is FinishReason.DONE

    @property
    def waiting(self) -> int | None:
        return None if self.admitted is None else self.admitted - self.arrival

    @property
    def latency(self) -> int | None:
        return None if self.finished is None else self.finished - self.arrival

    @property
    def latency_t(self) -> float | None:
        """Arrival -> termination on the cost clock (None until then)."""
        if self.finished_t is None:
            return None
        return self.finished_t - self.arrival_t


@dataclasses.dataclass
class Request:
    """One prompt's life in the scheduler.

    ``arrival``/``admitted``/``finished`` are step indices;
    ``arrival_t``/``admitted_t``/``finished_t`` are the same moments on
    the engine's cost clock.  ``deadline`` is an ABSOLUTE cost-clock
    time: once the clock reaches it the request is timed out — popped
    from the queue, or evicted mid-decode with its partial output.
    ``quality`` is the tier the request is actually served at (the
    admission policy may have downgraded it); ``requested`` preserves
    the caller's ask.  The scheduler treats both as opaque payload."""

    rid: int
    tokens: tuple[int, ...]  # prompt token ids
    max_new: int
    arrival: int
    quality: str | None = None
    requested: str | None = None
    deadline: float | None = None
    admitted: int | None = None
    finished: int | None = None
    arrival_t: float = 0.0
    admitted_t: float | None = None
    finished_t: float | None = None
    finish_reason: FinishReason | None = None
    detail: str = ""
    speculate: SpecConfig | None = None
    drafted: int = 0
    accepted: int = 0
    out: list[int] = dataclasses.field(default_factory=list)

    @property
    def waiting(self) -> int | None:
        """Steps spent queued before a slot opened (None until admitted)."""
        return None if self.admitted is None else self.admitted - self.arrival

    @property
    def latency(self) -> int | None:
        """Arrival -> last token, in steps (None until finished)."""
        return None if self.finished is None else self.finished - self.arrival

    def status(self, state: str) -> RequestStatus:
        return RequestStatus(
            rid=self.rid, state=state, finish_reason=self.finish_reason,
            tokens=list(self.out) if self.finish_reason is not None else None,
            n_tokens=len(self.out), quality=self.quality,
            requested=self.requested, arrival=self.arrival,
            admitted=self.admitted, finished=self.finished,
            arrival_t=self.arrival_t, admitted_t=self.admitted_t,
            finished_t=self.finished_t, deadline=self.deadline,
            detail=self.detail, drafted=self.drafted,
            accepted=self.accepted,
        )


class Scheduler:
    """Admission queue + slot state machine (host-side, deterministic).

    The engine drives it: ``submit`` enqueues, ``admissible`` pairs queued
    requests with FREE slots (FIFO), ``activate``/``start_decoding``
    transition an admission, ``record`` appends a decoded token,
    ``evict`` returns a DONE slot to FREE, and ``release``/``cancel``/
    ``expire_queued`` terminate early with a typed reason.  ``completed``
    keeps every finished Request for latency accounting; a bare ``poll``
    hands each newly-terminal status out exactly once, while ``poll(rid)``
    is an idempotent structured-status read.
    """

    def __init__(self, n_slots: int, max_queue: int | None = None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.states: list[SlotState] = [SlotState.FREE] * n_slots
        self.slot_req: list[Request | None] = [None] * n_slots
        self.queue: collections.deque[Request] = collections.deque()
        self.completed: dict[int, Request] = {}
        self._unclaimed: dict[int, Request] = {}
        self._next_rid = 0

    # -- admission ---------------------------------------------------------
    @property
    def queue_full(self) -> bool:
        return self.max_queue is not None and len(self.queue) >= self.max_queue

    def _new_request(self, tokens: Sequence[int], max_new: int, arrival: int,
                     quality, requested, deadline, arrival_t) -> Request:
        if len(tokens) == 0:
            raise SubmitRejected("every prompt must contain at least one token")
        if max_new < 1:
            raise SubmitRejected(f"max_new must be >= 1, got {max_new}")
        rid = self._next_rid
        self._next_rid += 1
        return Request(
            rid=rid, tokens=tuple(tokens), max_new=max_new, arrival=arrival,
            quality=quality, requested=requested, deadline=deadline,
            arrival_t=float(arrival) if arrival_t is None else float(arrival_t),
        )

    def submit(self, tokens: Sequence[int], max_new: int, arrival: int,
               quality: str | None = None, requested: str | None = None,
               deadline: float | None = None,
               arrival_t: float | None = None,
               speculate: SpecConfig | None = None) -> int:
        if self.queue_full:
            raise QueueFullError(
                f"admission queue is at its max_queue={self.max_queue} bound"
            )
        req = self._new_request(tokens, max_new, arrival, quality,
                                requested or quality, deadline, arrival_t)
        req.speculate = speculate
        self.queue.append(req)
        return req.rid

    def finish_unadmitted(self, tokens: Sequence[int], max_new: int,
                          arrival: int, reason: FinishReason,
                          quality: str | None = None,
                          requested: str | None = None,
                          arrival_t: float | None = None,
                          detail: str = "") -> int:
        """Issue a rid that is TERMINAL on arrival (``SHED``/``REJECTED``):
        the request never queues, never holds a slot, and surfaces through
        ``poll`` exactly like a served one — so overload outcomes are
        counted, not raised."""
        req = self._new_request(tokens, max_new, arrival, quality,
                                requested or quality, None, arrival_t)
        req.detail = detail
        self._finish(req, arrival, req.arrival_t, reason)
        return req.rid

    def admissible(self) -> Iterator[tuple[int, Request]]:
        """Pair queued requests with FREE slots, FIFO, popping both."""
        for slot in range(self.n_slots):
            if not self.queue:
                return
            if self.states[slot] is SlotState.FREE:
                yield slot, self.queue.popleft()

    def activate(self, slot: int, req: Request, step: int,
                 now: float | None = None) -> None:
        assert self.states[slot] is SlotState.FREE
        self.states[slot] = SlotState.PREFILLING
        self.slot_req[slot] = req
        req.admitted = step
        req.admitted_t = float(step) if now is None else float(now)

    def start_decoding(self, slot: int) -> None:
        assert self.states[slot] is SlotState.PREFILLING
        self.states[slot] = SlotState.DECODING

    # -- decode / eviction -------------------------------------------------
    def decoding_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.states) if s is SlotState.DECODING]

    def record(self, slot: int, token: int, step: int,
               now: float | None = None) -> bool:
        """Append one emitted token; True when the request just finished."""
        req = self.slot_req[slot]
        req.out.append(int(token))
        if len(req.out) >= req.max_new:
            self.states[slot] = SlotState.DONE
            req.finished = step
            req.finished_t = float(step) if now is None else float(now)
            req.finish_reason = FinishReason.DONE
            return True
        return False

    def _finish(self, req: Request, step: int, now: float,
                reason: FinishReason) -> None:
        if req.finish_reason is None or reason is not FinishReason.DONE:
            req.finish_reason = req.finish_reason or reason
        if req.finished is None:
            req.finished = step
            req.finished_t = float(now)
        self.completed[req.rid] = req
        self._unclaimed[req.rid] = req

    def evict(self, slot: int) -> Request:
        """Return a DONE slot to FREE; the Request moves to ``completed``."""
        assert self.states[slot] is SlotState.DONE
        req = self.slot_req[slot]
        self.states[slot] = SlotState.FREE
        self.slot_req[slot] = None
        self._finish(req, req.finished, req.finished_t, FinishReason.DONE)
        return req

    def release(self, slot: int, step: int, now: float,
                reason: FinishReason) -> Request:
        """Evict a live (DECODING) slot EARLY with a typed reason — the
        deadline/cancellation path.  The engine mirrors this with an
        active-mask flip (a data change, never a retrace); tokens already
        emitted stay on the Request as a partial result."""
        assert self.states[slot] in (SlotState.DECODING, SlotState.DONE)
        req = self.slot_req[slot]
        self.states[slot] = SlotState.FREE
        self.slot_req[slot] = None
        self._finish(req, step, now, reason)
        return req

    # -- deadlines / cancellation ------------------------------------------
    def expire_queued(self, step: int, now: float) -> list[Request]:
        """Pop every queued request whose deadline the cost clock has
        passed; each terminates TIMED_OUT without ever taking a slot."""
        expired = [r for r in self.queue
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            dead = {r.rid for r in expired}
            self.queue = collections.deque(
                r for r in self.queue if r.rid not in dead)
            for r in expired:
                self._finish(r, step, now, FinishReason.TIMED_OUT)
        return expired

    def expired_decoding(self, now: float) -> list[int]:
        """Slots whose live request is past its deadline (evict next)."""
        return [i for i in self.decoding_slots()
                if self.slot_req[i].deadline is not None
                and now >= self.slot_req[i].deadline]

    def cancel(self, rid: int, step: int,
               now: float) -> tuple[Request | None, int | None]:
        """Caller-initiated abort -> (request, freed slot | None).

        Queued requests are removed outright; a live one is released
        mid-decode (the engine must flip its active lane off).  Already-
        terminal rids return (None, None) — cancellation is idempotent.
        Unknown rids raise KeyError."""
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                self._finish(r, step, now, FinishReason.CANCELLED)
                return r, None
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                return self.release(slot, step, now,
                                    FinishReason.CANCELLED), slot
        if rid in self.completed:
            return None, None
        if not 0 <= rid < self._next_rid:
            raise KeyError(f"unknown request id {rid}")
        return None, None

    # -- results -----------------------------------------------------------
    def _state_of(self, req: Request) -> str:
        if req.finish_reason is not None:
            return "done"
        for slot, r in enumerate(self.slot_req):
            if r is req:
                return self.states[slot].value
        return "queued"

    def status(self, rid: int) -> RequestStatus:
        """Structured, idempotent view of one request (any known rid)."""
        req = self.completed.get(rid)
        if req is None:
            for r in self.slot_req:
                if r is not None and r.rid == rid:
                    req = r
                    break
        if req is None:
            for r in self.queue:
                if r.rid == rid:
                    req = r
                    break
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        return req.status(self._state_of(req))

    def poll(self, rid: int | None = None):
        """Structured request status.

        ``poll(rid)`` returns that request's :class:`RequestStatus` — an
        idempotent read for ANY issued rid, whatever its state (``.done``
        / ``.tokens`` say whether and how it terminated; a non-terminal
        status means "keep stepping").  ``poll()`` pops every request
        that TERMINATED since the last bare poll as {rid: status} —
        hand-out-once, so a drain loop sees each outcome exactly once.
        Unknown rids raise KeyError."""
        if rid is not None:
            return self.status(rid)
        out = {r: q.status("done") for r, q in self._unclaimed.items()}
        self._unclaimed.clear()
        return out

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(
            s in (SlotState.PREFILLING, SlotState.DECODING) for s in self.states
        )
