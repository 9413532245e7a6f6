"""Continuous-batching serving engine (the port of ``repro/serve/engine.py``).

Engines are built through ``EdgeArtifact.engine(quality=..., device=...)``:
matmul weights stay packed bit-planes on the device and every packed
matmul runs a CUDA kernel.  ``submit`` enqueues a prompt; each ``step``
enforces deadlines, admits queued requests into FREE slots (one
single-slot prefill at the request's own tier plus an in-place lane
insert, first token argmaxed on the device) and then runs ONE fixed-width
greedy decode over all lanes, with per-slot tiers as per-row plane masks
and the batch's minimum live tier as the plane-demand floor.  Each step
syncs the host once, on the (B,) next tokens.

``submit(speculate=SpecConfig(draft_tier, k))`` turns on self-speculative
decoding: k draft ticks through the same continuous-decode step with the
speculating lanes at their draft tier, then ONE verify pass at their
serving tier that accepts the longest agreeing prefix and rolls ``pos``
back over the rest; the tokens equal plain decode at the serving tier.

``generate()`` submits and drains on the continuous stream when the
engine is greedy and ``continuous``; otherwise (``temperature > 0`` or
``ServeConfig(continuous=False)``) it takes the static two-program path:
one prefill of every slot, then one decode loop with the next token fed
back on the device and one host sync at the end.  Sampling draws from a
``torch.Generator`` seeded from ``seed``.

The cost clock, deadlines, cancellation, ``QualityShed`` admission,
``stream_stats`` and the analytic byte meter follow the JAX engine
exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.qsq import SAME_PLAN_ROWS
from repro_torch.models.base import init_params, resolve_device
from repro_torch.serve.admission import ADMIT, REJECT, SHED, AdmissionPolicy, LoadView
from repro_torch.serve.scheduler import (
    FinishReason,
    Request,
    RequestStatus,
    Scheduler,
    SpecConfig,
    SubmitRejected,
    plane_demand,
)
from repro_torch.train.step import (
    make_admit_step,
    make_cache_prefill_step,
    make_cont_decode_step,
    make_decode_loop,
    make_sample_decode_loop,
    make_verify_step,
    sample_tokens,
)
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 256    # continuous sessions: KV cache length per slot
    temperature: float = 0.0  # 0 => greedy; > 0 => sampling (the static path)
    packed: bool = True  # keep matmul weights in bit-plane form
    continuous: bool = True
    max_prompt: int = 64  # continuous sessions: fixed prefill width
    max_queue: int | None = None
    admission: AdmissionPolicy | None = None


@dataclasses.dataclass(frozen=True)
class StepInfo:
    """What one :meth:`ServeEngine.step` did — host-side accounting only."""

    admitted: tuple[int, ...]
    finished: tuple[int, ...]
    timed_out: tuple[int, ...]
    live: int
    demand: int | None
    cost: float
    # speculative round: draft-tier tokens proposed this step and how many
    # of them the verify pass accepted (0/0 for plain decode steps)
    drafted: int = 0
    accepted: int = 0


class _Session:
    """Device state of one continuous stream: the live multi-slot cache, the
    per-slot current tokens / active mask / tiers, and the host scheduler."""

    def __init__(self, model, slots: int, prefill_len: int, cache_len: int,
                 device, max_queue: int | None = None):
        if prefill_len < 1:
            raise ValueError(f"prefill width must be >= 1, got {prefill_len}")
        if prefill_len >= cache_len:
            raise ValueError(f"cache_len {cache_len} leaves no decode room after the "
                             f"{prefill_len}-token prefill window")
        self.prefill_len = prefill_len
        self.cache_len = cache_len
        self.sched = Scheduler(slots, max_queue=max_queue)
        self.cache = init_params(model.cache_descs(slots, cache_len), device=device)
        # zeroed batch-1 cache reused by every admission (prefill never writes it)
        self.zero_slot_cache = init_params(model.cache_descs(1, cache_len), device=device)
        self.cur = np.zeros((slots, 1), np.int32)
        self.active = np.zeros((slots,), np.int32)
        self.tiers = np.zeros((slots,), np.int32)
        self.step_idx = 0
        self.now = 0.0
        self.plane_words_read = 0
        self.plane_words_full = 0
        self.tokens_emitted = 0
        # the same words by serving phase ("" plain, "draft", "verify"):
        # label -> [words read, words full]
        self.phase_words: dict[str, list[int]] = {}
        self.drafted = 0
        self.accepted = 0


class ServeEngine:
    def __init__(self, model, params, cfg: ServeConfig, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.n_packed_leaves = 0
        self.artifact = None
        self.quality: str | None = None
        self.tier_names: list[str] | None = None
        self.tier_ceiling: int = 0
        self._cont_step = make_cont_decode_step(model)
        self._admit = make_admit_step(model)
        self._verify = make_verify_step(model)
        self._prefill = make_cache_prefill_step(model)
        self._decode_loop = make_decode_loop(model)
        self._sample_loop = make_sample_decode_loop(model)
        self._session: _Session | None = None
        self._plane_words_cache: dict[int, tuple[int, int]] = {}

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- quality dial ------------------------------------------------------
    @property
    def per_request_quality(self) -> bool:
        return self.tier_names is not None

    def _clamp_ceiling(self, quality: str | None) -> str | None:
        if (self.tier_ceiling and self.tier_names is not None and quality is not None
                and self.tier_names.index(quality) < self.tier_ceiling):
            return self.tier_names[self.tier_ceiling]
        return quality

    def _resolve_quality(self, quality: str | None) -> str | None:
        if quality is None:
            return self._clamp_ceiling(self.quality)
        if self.tier_names is None:
            raise ValueError("per-request quality needs an engine with per-tier packed "
                             "weights (EdgeArtifact.engine); this engine serves one tier")
        if quality not in self.tier_names:
            raise KeyError(f"unknown quality tier {quality!r}; this engine has "
                           f"{self.tier_names}")
        return self._clamp_ceiling(quality)

    def _tier_index(self, quality: str | None) -> int:
        if self.tier_names is None or quality is None:
            return 0
        return self.tier_names.index(quality)

    def set_quality(self, quality: str) -> "ServeEngine":
        """Per-request engines: move the default tier.  Single-tier engines:
        re-resolve the params at the new tier (the stream must be idle)."""
        if self.artifact is None:
            raise ValueError("this engine was not built from an EdgeArtifact")
        if self.per_request_quality:
            self.quality = self._resolve_quality(quality)
            return self
        if self.has_work:
            raise RuntimeError("cannot re-dial quality while a continuous stream has "
                               "live requests; run_until_drained() first")
        self._session = None
        self._plane_words_cache.clear()
        self.params, self.n_packed_leaves = self.artifact.serve_params(
            quality, packed=self.cfg.packed, device=self.device)
        self.quality = quality
        return self

    # -- continuous batching ------------------------------------------------
    def _require_continuous(self):
        if self.cfg.temperature > 0:
            raise ValueError("the continuous scheduler is greedy-only; build the engine "
                             "with temperature=0 (generate() still samples via the "
                             "static path)")

    def _ensure_session(self) -> _Session:
        if self._session is None:
            self._session = _Session(self.model, self.cfg.batch_slots,
                                     prefill_len=self.cfg.max_prompt,
                                     cache_len=self.cfg.max_len, device=self.device,
                                     max_queue=self.cfg.max_queue)
        return self._session

    def _admission_view(self, s: _Session) -> LoadView:
        names = (tuple(self.tier_names) if self.tier_names is not None
                 else (self.quality or "default",))
        return LoadView(
            step=s.step_idx, now=s.now, n_slots=s.sched.n_slots,
            tier_names=names, tier_costs=self.tier_cost_table(),
            queued=tuple((self._tier_index(r.quality), r.max_new) for r in s.sched.queue),
            live=tuple((self._tier_index(r.quality), max(r.max_new - len(r.out), 0))
                       for r in s.sched.slot_req if r is not None),
        )

    def submit(self, prompt: Sequence[int], max_new: int = 32, quality: str | None = None,
               deadline: float | None = None, speculate: SpecConfig | None = None) -> int:
        """Enqueue one prompt on the continuous stream; returns a request id
        (see the JAX engine's ``submit`` for the full contract).
        ``speculate`` drafts the request at a cheaper tier and verifies each
        window at its serving tier; its tokens equal plain decode."""
        self._require_continuous()
        quality = self._resolve_quality(quality)
        requested = quality
        if speculate is not None:
            self._check_speculate(speculate, quality)
        s = self._ensure_session()
        if len(prompt) > s.prefill_len:
            raise SubmitRejected(
                f"prompt of {len(prompt)} tokens exceeds the stream's fixed "
                f"{s.prefill_len}-token prefill window; raise ServeConfig.max_prompt")
        if s.prefill_len + max_new > s.cache_len:
            raise SubmitRejected(
                f"prefill window {s.prefill_len} + max_new {max_new} exceeds the "
                f"{s.cache_len}-entry slot cache; raise ServeConfig.max_len")
        if deadline is not None and not deadline > 0:
            raise SubmitRejected(f"deadline must be a positive cost-clock budget, "
                                 f"got {deadline}")
        if s.sched.queue_full:
            return s.sched.finish_unadmitted(
                prompt, max_new, s.step_idx, FinishReason.REJECTED, quality=quality,
                requested=requested, arrival_t=s.now,
                detail=f"bounded queue full (max_queue={s.sched.max_queue})")
        if self.cfg.admission is not None:
            d = self.cfg.admission.decide(self._tier_index(quality), max_new,
                                          self._admission_view(s))
            if d.action == ADMIT:
                if d.tier is not None and self.tier_names is not None:
                    quality = self.tier_names[max(int(d.tier), self.tier_ceiling)]
            elif d.action in (SHED, REJECT):
                reason = FinishReason.SHED if d.action == SHED else FinishReason.REJECTED
                return s.sched.finish_unadmitted(
                    prompt, max_new, s.step_idx, reason, quality=quality,
                    requested=requested, arrival_t=s.now, detail=d.detail)
            else:
                raise ValueError(f"admission policy returned unknown action {d.action!r}")
        abs_deadline = None if deadline is None else s.now + float(deadline)
        return s.sched.submit(prompt, max_new, arrival=s.step_idx, quality=quality,
                              requested=requested, deadline=abs_deadline, arrival_t=s.now,
                              speculate=speculate)

    def _check_speculate(self, sc: SpecConfig, quality: str | None) -> None:
        """Reject speculation configs that could never save a weight read."""
        if not self.per_request_quality:
            raise SubmitRejected(
                "speculative decoding drafts at a cheaper tier of the same packed "
                "weights, which needs a per-request-quality engine (EdgeArtifact.engine)")
        if self.model.cfg.window is not None:
            raise SubmitRejected("speculative decoding needs a full-length KV cache")
        if sc.k < 1:
            raise SubmitRejected(f"speculate.k must be >= 1 drafted tokens, got {sc.k}")
        if sc.draft_tier not in self.tier_names:
            raise SubmitRejected(f"unknown draft tier {sc.draft_tier!r}; this engine has "
                                 f"{self.tier_names}")
        if self.tier_names.index(sc.draft_tier) <= self._tier_index(quality):
            raise SubmitRejected(
                f"draft tier {sc.draft_tier!r} is not below serving tier {quality!r} on "
                f"the ladder {self.tier_names}; drafting there could never save weight "
                f"reads")

    def cancel(self, rid: int) -> RequestStatus:
        """Caller-initiated abort (queued: removed; live: evicted)."""
        if self._session is None:
            raise KeyError(f"unknown request id {rid} (no active stream)")
        s = self._session
        _, slot = s.sched.cancel(rid, s.step_idx, s.now)
        if slot is not None:
            s.active[slot] = 0
        return s.sched.status(rid)

    def _forward_plane_words(self, demand: int) -> tuple[int, int]:
        """(words_read, words_full): packed plane words ONE forward streams at
        plane-demand floor ``demand`` vs. reading every plane (analytic)."""
        from repro_torch.quant.store import PackedWeight

        cached = self._plane_words_cache.get(demand)
        if cached is not None:
            return cached
        read = full = 0
        for leaf in tree_leaves(self.params, is_leaf=lambda x: isinstance(x, PackedWeight)):
            if not isinstance(leaf, PackedWeight):
                continue
            words = leaf.planes.numel() // 3
            full += 3 * words
            n_read = 3 - leaf.demand_drop(demand) if leaf.plane_major else 3
            read += n_read * words
        self._plane_words_cache[demand] = (read, full)
        return read, full

    def _dispatch_cost(self, demand: int) -> float:
        read, full = self._forward_plane_words(demand)
        return read / full if full else 1.0

    def tier_cost_table(self) -> tuple[float, ...]:
        n = len(self.tier_names) if self.tier_names is not None else 1
        return tuple(self._dispatch_cost(t) for t in range(n))

    def stream_stats(self) -> dict:
        """Demand-streaming meter of the current stream: bytes per emitted
        (for speculative streams: accepted) token, and the draft counters."""
        s = self._session
        if s is None or s.tokens_emitted == 0:
            return {"tokens": 0, "bytes_read": 0, "bytes_full": 0,
                    "bytes_per_token": 0.0, "read_frac": 1.0,
                    "drafted": 0, "accepted": 0, "acceptance_rate": 0.0}
        bytes_read = 4 * s.plane_words_read
        bytes_full = 4 * s.plane_words_full
        return {
            "tokens": s.tokens_emitted,
            "bytes_read": bytes_read,
            "bytes_full": bytes_full,
            "bytes_per_token": bytes_read / s.tokens_emitted,
            "read_frac": bytes_read / bytes_full if bytes_full else 1.0,
            "drafted": s.drafted,
            "accepted": s.accepted,
            "acceptance_rate": s.accepted / s.drafted if s.drafted else 0.0,
        }

    def _meter(self, s: _Session, demand: int, phase: str = "") -> float:
        """Charge one forward at ``demand`` to the byte meter; returns its cost."""
        r, f = self._forward_plane_words(demand)
        s.plane_words_read += r
        s.plane_words_full += f
        words = s.phase_words.setdefault(phase, [0, 0])
        words[0] += r
        words[1] += f
        return self._dispatch_cost(demand)

    def step(self) -> StepInfo:
        """One scheduler iteration: deadlines, admissions (each a single-slot
        prefill at the request's tier, first token from its logits), then
        one decode over all lanes at the batch's plane-demand floor."""
        s = self._ensure_session()
        admitted: list[int] = []
        finished: list[int] = []
        timed_out: list[int] = []
        cost = 0.0
        for req in s.sched.expire_queued(s.step_idx, s.now):
            timed_out.append(req.rid)
        for slot in s.sched.expired_decoding(s.now):
            req = s.sched.release(slot, s.step_idx, s.now, FinishReason.TIMED_OUT)
            s.active[slot] = 0
            timed_out.append(req.rid)
        for slot, req in s.sched.admissible():
            s.sched.activate(slot, req, s.step_idx, now=s.now)
            s.tiers[slot] = self._tier_index(req.quality)
            admitted.append(req.rid)
            toks = np.zeros((1, s.prefill_len), np.int32)
            toks[0, s.prefill_len - len(req.tokens):] = req.tokens
            demand = int(s.tiers[slot])
            s.cache, first = self._admit(
                self.params, s.zero_slot_cache, s.cache, self._t(toks),
                self._t(np.asarray([len(req.tokens)], np.int32)), slot,
                self._t(s.tiers[slot:slot + 1]), demand)
            cost += self._meter(s, demand)
            s.tokens_emitted += 1
            first = int(first)  # the admission's one host sync
            s.sched.start_decoding(slot)
            s.cur[slot, 0] = first
            if s.sched.record(slot, first, s.step_idx, now=s.now):
                s.sched.evict(slot)
                finished.append(req.rid)
            else:
                s.active[slot] = 1
        live = s.sched.decoding_slots()
        demand_used: int | None = None
        drafted_n = accepted_n = 0
        # speculating slots this round: slot -> (k_eff, draft tier index); k
        # is clamped so a round never drafts past max_new (the verify's bonus
        # token is the +1) and the verify window keeps at most SAME_PLAN_ROWS
        # rows (so each verify row is a decode row bit for bit on the card),
        # and a request downgraded to or below its draft tier decodes plainly
        k_cap = SAME_PLAN_ROWS // s.sched.n_slots - 1
        spec: dict[int, tuple[int, int]] = {}
        for slot in live:
            req = s.sched.slot_req[slot]
            if req.speculate is None:
                continue
            didx = self.tier_names.index(req.speculate.draft_tier)
            if didx <= int(s.tiers[slot]):
                continue
            k_eff = min(req.speculate.k, req.max_new - len(req.out) - 1, k_cap)
            if k_eff >= 1:
                spec[slot] = (k_eff, didx)
        if spec:
            demand_used, rcost, drafted_n, accepted_n = self._spec_round(s, spec, finished)
            cost += rcost
        elif live:
            demand = plane_demand(s.tiers[slot] for slot in live)
            demand_used = demand
            nxt, s.cache = self._cont_step(self.params, s.cache, self._t(s.cur),
                                           self._t(s.active), self._t(s.tiers), demand)
            cost += self._meter(s, demand)
            s.tokens_emitted += len(live)
            nxt = nxt.cpu().numpy()  # the step's one host sync
            for slot in live:
                s.cur[slot, 0] = nxt[slot]
                rid = s.sched.slot_req[slot].rid
                if s.sched.record(slot, int(nxt[slot]), s.step_idx, now=s.now):
                    s.sched.evict(slot)
                    s.active[slot] = 0
                    finished.append(rid)
        s.step_idx += 1
        s.now += cost
        return StepInfo(admitted=tuple(admitted), finished=tuple(finished),
                        timed_out=tuple(timed_out), live=len(live),
                        demand=demand_used, cost=cost, drafted=drafted_n, accepted=accepted_n)

    def _spec_round(self, s: _Session, spec: dict[int, tuple[int, int]],
                    finished: list[int]) -> tuple[int, float, int, int]:
        """One self-speculative draft/verify round over the live lanes (the
        JAX engine's ``_spec_round``).

        DRAFT: k ticks of the continuous-decode step with the speculating
        lanes' tiers set to their draft tier, so the demand floor streams
        only the draft planes; the other live lanes decode normally in the
        same calls and their tokens are recorded each tick.  A lane whose
        k_eff is shorter than the round's goes inactive early.  One host
        sync a tick, on the (B,) tokens.

        VERIFY: ONE pass at the lanes' serving tiers scores every window
        position, overwriting the draft-tier KV in place, and accepts each
        lane's longest agreeing prefix on the device; the lane emits the
        accepted drafts plus the bonus token, every one what plain decode
        would have produced.  One host sync, on (B, W) tokens and (B,)
        counts together.

        The cost clock charges each draft tick at its demand floor and the
        verify as ONE serving-tier dispatch.  Returns (verify demand, round
        cost, drafted, accepted)."""
        k_round = max(k for k, _ in spec.values())
        # every live lane holds prefill_len + emitted - 1 cache entries
        start = {slot: s.prefill_len + len(s.sched.slot_req[slot].out) - 1 for slot in spec}
        anchor = {slot: int(s.cur[slot, 0]) for slot in spec}
        drafts: dict[int, list[int]] = {slot: [] for slot in spec}
        cost = 0.0
        for j in range(k_round):
            draft_active = s.active.copy()
            draft_tiers = s.tiers.copy()
            for slot, (k_eff, didx) in spec.items():
                draft_active[slot] = 1 if j < k_eff else 0
                draft_tiers[slot] = didx
            live_now = [slot for slot in range(s.sched.n_slots) if draft_active[slot]]
            if not live_now:
                break  # every plain lane finished and every k_eff ran out
            demand = plane_demand(int(draft_tiers[slot]) for slot in live_now)
            with dispatch.dispatch_phase("draft"):
                nxt, s.cache = self._cont_step(self.params, s.cache, self._t(s.cur),
                                               self._t(draft_active), self._t(draft_tiers),
                                               demand)
            cost += self._meter(s, demand, "draft")
            nxt = nxt.cpu().numpy()  # the tick's one host sync
            for slot in live_now:
                s.cur[slot, 0] = int(nxt[slot])
                if slot in spec:
                    drafts[slot].append(int(nxt[slot]))  # proposed, not emitted
                    continue
                s.tokens_emitted += 1
                rid = s.sched.slot_req[slot].rid
                if s.sched.record(slot, int(nxt[slot]), s.step_idx, now=s.now):
                    s.sched.evict(slot)
                    s.active[slot] = 0
                    finished.append(rid)
        n = s.sched.n_slots
        window = np.zeros((n, k_round + 1), np.int32)
        wlen = np.zeros((n,), np.int32)
        smask = np.zeros((n,), np.int32)
        starts = np.zeros((n,), np.int32)
        for slot, (k_eff, _) in spec.items():
            window[slot, 0] = anchor[slot]
            window[slot, 1:1 + k_eff] = drafts[slot]
            wlen[slot] = k_eff + 1
            smask[slot] = 1
            starts[slot] = start[slot]
        vdemand = plane_demand(int(s.tiers[slot]) for slot in spec)
        with dispatch.dispatch_phase("verify"):
            toks, acc, s.cache = self._verify(self.params, s.cache, self._t(window),
                                              self._t(starts), self._t(wlen), self._t(smask),
                                              self._t(s.tiers), vdemand)
        cost += self._meter(s, vdemand, "verify")
        out = torch.cat([toks, acc[:, None]], dim=1).cpu().numpy()  # the round's last sync
        drafted_n = accepted_n = 0
        for slot, (k_eff, _) in spec.items():
            a = int(out[slot, -1])
            req = s.sched.slot_req[slot]
            req.drafted += k_eff
            req.accepted += a
            drafted_n += k_eff
            accepted_n += a
            s.cur[slot, 0] = int(out[slot, a])  # the bonus token is the new cur
            s.tokens_emitted += a + 1
            done = False
            for tok in out[slot, :a + 1]:
                done = s.sched.record(slot, int(tok), s.step_idx, now=s.now)
            if done:  # a + 1 <= remaining, so only the last token can finish
                s.sched.evict(slot)
                s.active[slot] = 0
                finished.append(req.rid)
        s.drafted += drafted_n
        s.accepted += accepted_n
        return vdemand, cost, drafted_n, accepted_n

    def poll(self, rid: int | None = None):
        """Structured request status; ``poll()`` hands out every request that
        terminated since the last bare poll."""
        if self._session is None:
            if rid is None:
                return {}
            raise KeyError(f"unknown request id {rid} (no active stream)")
        return self._session.sched.poll(rid)

    # -- stream introspection ----------------------------------------------
    @property
    def has_work(self) -> bool:
        return self._session is not None and self._session.sched.has_work

    @property
    def step_count(self) -> int:
        """step() iterations the current stream has run."""
        return 0 if self._session is None else self._session.step_idx

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot."""
        return 0 if self._session is None else len(self._session.sched.queue)

    @property
    def completed_requests(self) -> dict[int, Request]:
        """Every finished Request of the current stream (rid -> Request)."""
        return {} if self._session is None else dict(self._session.sched.completed)

    @property
    def now(self) -> float:
        """The stream cost clock (a full-quality dispatch = 1.0)."""
        return 0.0 if self._session is None else self._session.now

    def advance_clock(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot rewind the cost clock (dt={dt})")
        s = self._ensure_session()
        s.now += float(dt)
        return s.now

    def reset_stream(self) -> None:
        self._session = None

    def run_until_drained(self, max_ticks: int | None = None):
        """step() until the queue and every slot are empty; returns what
        :meth:`poll` would.  ``max_ticks`` is a watchdog."""
        s = self._ensure_session()
        if max_ticks is None:
            outstanding = sum(r.max_new for r in s.sched.queue)
            outstanding += sum(max(r.max_new - len(r.out), 1)
                               for r in s.sched.slot_req if r is not None)
            max_ticks = 2 * outstanding + s.sched.n_slots + 16
        n = 0
        while s.sched.has_work:
            if n >= max_ticks:
                raise RuntimeError(
                    f"run_until_drained watchdog: stream not drained after {n} ticks "
                    f"({len(s.sched.queue)} queued, {len(s.sched.decoding_slots())} "
                    f"decoding)")
            self.step()
            n += 1
        return self.poll()

    # -- generation ----------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]], max_new: int = 32,
                 seed: int = 0, qualities=None):
        """Decode a batch of prompts; returns lists of ids.  Greedy
        continuous engines submit all and drain; ``temperature > 0`` or
        ``continuous=False`` takes the static path (same seed and prompts,
        same tokens).  ``qualities`` (continuous path only) gives each
        prompt its own tier."""
        if len(prompts) == 0:
            return []
        if any(len(p) == 0 for p in prompts):
            raise ValueError("every prompt must contain at least one token")
        b = len(prompts)
        if b > self.cfg.batch_slots:
            raise ValueError(f"{b} prompts exceed the engine's {self.cfg.batch_slots} "
                             f"batch_slots")
        if max_new < 1:
            return [[] for _ in prompts]
        if isinstance(qualities, str):
            qualities = [qualities] * b
        if qualities is not None and len(qualities) != b:
            raise ValueError(f"{len(qualities)} qualities for {b} prompts")
        if self.cfg.continuous and self.cfg.temperature == 0:
            return self._generate_continuous(prompts, max_new, qualities)
        if qualities is not None:
            raise ValueError("per-request qualities need the continuous scheduler path "
                             "(greedy, ServeConfig(continuous=True)); use set_quality() "
                             "to dial this engine as a whole")
        return self._generate_static(prompts, max_new, seed)

    def _generate_continuous(self, prompts, max_new: int, qualities=None):
        """Submit-all/drain on a throwaway session sized to this batch."""
        maxp = max(len(p) for p in prompts)
        saved = self._session
        self._session = _Session(self.model, self.cfg.batch_slots, prefill_len=maxp,
                                 cache_len=maxp + max_new + 1, device=self.device)
        try:
            rids = [self.submit(p, max_new=max_new,
                                quality=None if qualities is None else qualities[i])
                    for i, p in enumerate(prompts)]
            done = self.run_until_drained()
            return [done[r].tokens for r in rids]
        finally:
            self._session = saved

    def _generate_static(self, prompts, max_new: int, seed: int):
        """The one-static-batch path: every slot prefills at once (M = slots x
        longest prompt) and decodes in lockstep; one host sync at the end."""
        b = len(prompts)
        slots = self.cfg.batch_slots
        maxp = max(len(p) for p in prompts)
        cache = init_params(self.model.cache_descs(slots, maxp + max_new + 1),
                            device=self.device)
        toks = np.zeros((slots, maxp), np.int32)
        lens = np.zeros((slots,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, maxp - len(p):] = p  # left-pad
            lens[i] = len(p)
        cache, logits = self._prefill(self.params, cache, self._t(toks), self._t(lens))
        temp = self.cfg.temperature
        if temp > 0:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            first = sample_tokens(logits, temp, gen)[:, None]
            out, _ = self._sample_loop(self.params, cache, first, max_new, gen, temp)
        else:
            first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out, _ = self._decode_loop(self.params, cache, first, max_new)
        out = out.cpu().numpy()  # (max_new, slots): the generation's one host sync
        return [out[:, i].tolist() for i in range(b)]
