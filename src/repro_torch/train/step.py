"""Training and serving step builders (the port of ``repro/train/step.py``).

PyTorch runs eagerly, so the builders return plain functions; ``demand``
stays a Python int (at most one kernel specialisation per tier) and
``tiers``/``active`` stay tensors (a tier change is a data change).  The
serving steps write every cache field they change in place, take no host
sync and copy nothing from the host, so the engine can capture each as a
CUDA graph (``serve/graphs.py``).  The
train step differentiates the loss with autograd over plain tensor ops,
QSQ-compresses the gradients (the K5 kernel on a card) and applies AdamW.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer
from repro_torch.optim import (
    AdamWConfig,
    GradCompressionConfig,
    adamw_update,
    compress_grads,
    cosine_schedule,
)
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_map


def make_train_step(model, opt_cfg: AdamWConfig | None = None,
                    cc: GradCompressionConfig | None = None,
                    total_steps: int = 100000) -> Callable:
    """(TrainState, batch) -> (TrainState, metrics).  The input state is
    left untouched; metrics ``loss``, ``grad_norm`` and ``lr_scale`` are
    0-d tensors on the state's device, ``grad_wire_bytes`` a float."""
    opt_cfg = opt_cfg or AdamWConfig()
    cc = cc or GradCompressionConfig()

    def train_step(state: TrainState, batch: dict):
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            loss = model.loss(params, batch)
            loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        with torch.no_grad():
            grads, new_err, wire_bytes = compress_grads(grads, state.err, cc)
            lr_scale = cosine_schedule(state.opt.step, warmup=max(total_steps // 20, 1),
                                       total=total_steps)
            new_params, new_opt, gnorm = adamw_update(opt_cfg, params, grads, state.opt,
                                                      lr_scale)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr_scale": lr_scale,
                   "grad_wire_bytes": wire_bytes}
        return TrainState(params=new_params, opt=new_opt, err=new_err), metrics

    return train_step


def make_prefill_step(model) -> Callable:
    """(params, batch) -> logits: inference prefill."""
    return lambda params, batch: model.forward(params, batch)


def make_serve_step(model) -> Callable:
    """(params, cache, batch) -> (next_tokens (B, 1), cache): one greedy decode step."""

    def serve_step(params, cache, batch):
        logits, cache = model.decode(params, cache, batch)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None], cache

    return serve_step


def supports_fused_prefill(model) -> bool:
    """True if the family primes its cache with ONE full-sequence forward
    (attention-only stacks).  Recurrent families (ssm/hybrid) and
    cross-attending ones (vlm/encdec) keep the scanned per-token path."""
    return model.fused_prefill


def make_cache_prefill_step(model) -> Callable:
    """(params, cache, tokens (B, S), lengths (B,), tiers, demand) ->
    (new cache, last_logits (B, V)).

    Attention families run one full-sequence causal pass over the
    left-padded prompts, with the pads masked out of the KV cache.  Other
    families scan the prompt through ``model.decode`` one position at a
    time (weights stream once per token) on a copy of ``cache``;
    ``lengths`` is unused there, as in the JAX package: left pads pass
    through the recurrent state, which offers no post-hoc pad masking."""
    if supports_fused_prefill(model):
        def prefill_step(params, cache, tokens, lengths, tiers=None, demand=None):
            return transformer.lm_prefill(params, model.cfg, cache, tokens, lengths,
                                          tiers=tiers, demand=demand)

        return prefill_step

    def scanned_prefill(params, cache, tokens, lengths, tiers=None, demand=None):
        del lengths  # per-token scan: no pad isolation for recurrent state
        if tiers is not None or demand is not None:
            raise ValueError(f"per-slot quality tiers need the fused attention prefill; "
                             f"family {model.cfg.family!r} serves one tier per engine")
        cache = tree_map(torch.clone, cache)  # decode writes in place; the input stays
        for t in range(tokens.shape[1]):
            logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        return cache, logits[:, -1, :]

    return scanned_prefill


def make_admit_step(model) -> Callable:
    """(params, zero_cache (batch-1), live_cache, toks (1, P), lens (1,),
    slot (1,), tier (1,), demand (int)) -> (live_cache, first_token ()).

    Single-slot prefill at the request's own tier, lane insert into the live
    cache (in place) and the request's first greedy token argmaxed on the
    device: the caller syncs on one int32.  ``slot`` is a device tensor (an
    int also works), so one captured admission serves every lane."""
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


def make_verify_step(model) -> Callable:
    """(params, cache, window (B, W), start (B,), wlen (B,), spec (B,),
    tiers (B,), demand) -> (tokens (B, W), accepted (B,), cache).

    The verify half of self-speculative decoding, acceptance computed on
    the device: row j of ``tokens`` is the verify tier's greedy choice
    after window position j, and ``accepted`` the longest prefix of drafts
    (``window[:, 1:]``) that match it, so a lane emits
    ``tokens[:accepted + 1]``.  The KV rollback is one data change, made in
    the caller's ``pos`` buffer: each speculating lane's ``pos`` becomes
    ``start + accepted + 1``, and the rejected entries stay in the cache,
    masked until overwritten.  Lanes with ``wlen == 0`` pass through
    untouched."""

    def verify(params, cache, window, start, wlen, spec, tiers, demand=0):
        logits, cache = model.verify(params, cache, {
            "tokens": window, "start": start, "wlen": wlen, "spec": spec,
            "tiers": tiers, "demand": demand})
        toks = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, W)
        w = window.shape[1]
        # draft i+1 is accepted iff it matches the verify choice at window
        # position i and every earlier draft was accepted too
        eq = (toks[:, : w - 1] == window[:, 1:]) & (
            torch.arange(w - 1, device=window.device)[None, :] < (wlen - 1)[:, None])
        accepted = torch.sum(torch.cumprod(eq.to(torch.int32), dim=1), dim=1).to(torch.int32)
        pos = cache.kv.pos
        pos.copy_(torch.where(spec[None, :] > 0, (start + accepted + 1)[None, :], pos))
        return toks, accepted, cache

    return verify


def make_decode_loop(model) -> Callable:
    """(params, cache, first (B, 1), steps) -> (tokens (steps, B), cache).

    Greedy multi-token decode with the next token fed back on the device:
    the host syncs once, on the returned block.  ``first`` is the token
    chosen from the prefill logits; row t is the token fed at step t (so
    row 0 == first)."""

    def decode_loop(params, cache, first, steps: int):
        cur, rows = first, []
        for _ in range(steps):
            rows.append(cur[:, 0])
            logits, cache = model.decode(params, cache, {"tokens": cur})
            cur = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return torch.stack(rows), cache

    return decode_loop


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits / temperature)`` (Gumbel-max,
    as ``jax.random.categorical`` draws) -> (rows,) int32."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def make_sample_decode_loop(model) -> Callable:
    """(params, cache, first (B, 1), steps, generator, temperature) ->
    (tokens (steps, B), cache): the temperature-sampled sibling of
    :func:`make_decode_loop`, each next token drawn by :func:`sample_tokens`
    from ``generator``; still no host sync inside the loop."""

    def decode_loop(params, cache, first, steps: int, generator, temperature: float):
        cur, rows = first, []
        for _ in range(steps):
            rows.append(cur[:, 0])
            logits, cache = model.decode(params, cache, {"tokens": cur})
            cur = sample_tokens(logits[:, -1, :], temperature, generator)[:, None]
        return torch.stack(rows), cache

    return decode_loop
