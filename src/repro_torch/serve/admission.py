"""SLO admission control: degrade quality instead of latency.

The paper's tiers are ONE set of packed 3-bit weights with per-tier LSB
plane drops — so under overload the serving stack has a cheaper product
on the same shelf: admit the request at a lower tier and every one of
its dispatches streams fewer weight planes (per-row plane masks
realize the tier inside the shared dispatch; the plane-demand floor
turns it into shorter weight reads).  This module is the decision layer:
a pluggable :class:`AdmissionPolicy` consulted by
``ServeEngine.submit`` with a :class:`LoadView` snapshot, answering
ADMIT (possibly at a downgraded tier), SHED (even the cheapest tier
cannot meet the SLO — terminal ``FinishReason.SHED``) or REJECT
(structural refusal — terminal ``FinishReason.REJECTED``).

Everything here is host-side, with no tensor code (a copy of the JAX
package's module, owned by the port).  Costs are denominated in
the engine's dispatch cost clock: one full-quality forward = 1.0, a
demand-shortened forward = its weight-read fraction
(``ServeEngine.tier_cost_table``) — the HBM-bandwidth time model the
plane-streaming kernels optimize.  :class:`QualityShed` is a greedy
knapsack over that table: outstanding work defines the occupied
capacity, and each arrival is admitted at the best (highest-quality)
tier whose added cost still fits the latency budget — shrinking the
item rather than dropping it, and shedding only when even the smallest
size misses.  The system self-regulates: every downgraded admission
adds less outstanding cost, so the estimated wait later arrivals see
grows slower, which is exactly Moons et al.'s system-level
energy/accuracy tradeoff applied to admission control.
"""
from __future__ import annotations

import dataclasses

ADMIT = "admit"
SHED = "shed"
REJECT = "reject"


@dataclasses.dataclass(frozen=True)
class SLOBudget:
    """The service-level objective admission decisions are made against.

    ``latency`` is the end-to-end budget per request — arrival to last
    token — in cost-clock units (full-quality dispatches).  ``max_queue``
    optionally REJECTS outright past a queue depth, independent of the
    latency estimate (a structural cap on buffered work)."""

    latency: float
    max_queue: int | None = None


@dataclasses.dataclass(frozen=True)
class LoadView:
    """What a policy sees at one submit: the stream's outstanding work.

    ``queued``/``live`` list (tier index, remaining dispatches) per
    request; ``tier_costs[t]`` is the engine's per-dispatch cost at tier
    ``t`` (indexed like ``tier_names``, best quality first)."""

    step: int
    now: float
    n_slots: int
    tier_names: tuple[str, ...]
    tier_costs: tuple[float, ...]
    queued: tuple[tuple[int, int], ...]
    live: tuple[tuple[int, int], ...]

    def outstanding_cost(self) -> float:
        """Cost-clock units of work already accepted and not yet served."""
        return sum(n * self.tier_costs[t]
                   for t, n in self.queued + self.live)

    def estimated_wait(self) -> float:
        """Optimistic clock time until a NEW arrival starts being served:
        outstanding cost spread across the slots.  Optimistic because the
        batch demand floor couples lanes (a single hi lane keeps the
        shared dispatch at hi cost); policies should treat it as a lower
        bound and budget accordingly."""
        return self.outstanding_cost() / max(self.n_slots, 1)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """``action`` is ADMIT/SHED/REJECT; ``tier`` the (possibly
    downgraded) tier index to serve at when admitting; ``detail`` a
    human-readable why, surfaced on the request's terminal status."""

    action: str
    tier: int | None = None
    detail: str = ""


class AdmissionPolicy:
    """Strategy hook consulted once per ``submit`` (never on the decode
    path — admission is pure host bookkeeping, zero retrace risk)."""

    def decide(self, tier: int, n_dispatches: int,
               view: LoadView) -> AdmissionDecision:
        raise NotImplementedError


class AdmitAll(AdmissionPolicy):
    """The pre-SLO discipline: FIFO, requested tier, unbounded wait —
    the overload baseline the bench replays against QualityShed."""

    def decide(self, tier: int, n_dispatches: int,
               view: LoadView) -> AdmissionDecision:
        return AdmissionDecision(ADMIT, tier=tier)


@dataclasses.dataclass
class QualityShed(AdmissionPolicy):
    """Greedy quality-scalable shedding against an :class:`SLOBudget`.

    For each arrival, walk the tier ladder from the requested tier down:
    the first tier whose estimated completion (current estimated wait +
    the request's own dispatches at that tier's cost) fits the latency
    budget wins.  If even the cheapest tier misses, SHED — the typed
    outcome the caller can retry later — rather than queue work that is
    already doomed to time out.  ``budget.max_queue`` REJECTs on queue
    depth before any estimating."""

    budget: SLOBudget

    def decide(self, tier: int, n_dispatches: int,
               view: LoadView) -> AdmissionDecision:
        if (self.budget.max_queue is not None
                and len(view.queued) >= self.budget.max_queue):
            return AdmissionDecision(
                REJECT,
                detail=(f"queue depth {len(view.queued)} at the policy cap "
                        f"{self.budget.max_queue}"),
            )
        wait = view.estimated_wait()
        for t in range(tier, len(view.tier_costs)):
            est = wait + n_dispatches * view.tier_costs[t]
            if est <= self.budget.latency:
                detail = ("" if t == tier else
                          f"downgraded {view.tier_names[tier]} -> "
                          f"{view.tier_names[t]}: est {est:.2f} fits "
                          f"budget {self.budget.latency:.2f}")
                return AdmissionDecision(ADMIT, tier=t, detail=detail)
        floor = len(view.tier_costs) - 1
        est = wait + n_dispatches * view.tier_costs[floor]
        return AdmissionDecision(
            SHED,
            detail=(f"even {view.tier_names[floor]} estimates {est:.2f} "
                    f"against budget {self.budget.latency:.2f}"),
        )
