"""Serving step builders (the port of ``repro/train/step.py``).

PyTorch runs eagerly, so the builders return plain functions; ``demand``
stays a Python int (at most one kernel specialisation per tier) and
``tiers``/``active`` stay tensors (a tier change is a data change).
The training step is not ported yet (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer


def make_cache_prefill_step(model) -> Callable:
    """(params, cache, tokens (B, S), lengths (B,), tiers, demand) ->
    (new cache, last_logits (B, V)): one full-sequence causal pass over the
    left-padded prompts."""

    def prefill_step(params, cache, tokens, lengths, tiers=None, demand=None):
        return transformer.lm_prefill(params, model.cfg, cache, tokens, lengths,
                                      tiers=tiers, demand=demand)

    return prefill_step


def make_admit_step(model) -> Callable:
    """(params, zero_cache (batch-1), live_cache, toks (1, P), lens (1,),
    slot (int), tier (1,), demand (int)) -> (live_cache, first_token ()).

    Single-slot prefill at the request's own tier, lane insert into the live
    cache (in place) and the request's first greedy token argmaxed on the
    device: the caller syncs on one int32."""
    prefill = make_cache_prefill_step(model)

    def admit(params, zero_cache, live_cache, toks, lens, slot, tier, demand=0):
        one_cache, logits = prefill(params, zero_cache, toks, lens, tier, demand)
        cache = model.cache_insert_slot(live_cache, one_cache, slot)
        return cache, torch.argmax(logits[0]).to(torch.int32)

    return admit


def make_cont_decode_step(model) -> Callable:
    """(params, cache, cur (B,1), active (B,), tiers (B,), demand) ->
    (next (B,), cache): one greedy decode iteration over all slots at a
    fixed batch width; inactive lanes hold their token and their ``pos``."""

    def cont_step(params, cache, cur, active, tiers, demand=0):
        logits, cache = model.decode(params, cache, {
            "tokens": cur, "active": active, "tiers": tiers, "demand": demand})
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return torch.where(active > 0, nxt, cur[:, 0]), cache

    return cont_step
