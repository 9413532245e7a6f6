"""Dense decoder-only LM (the port of ``repro/models/transformer.py``).

Layer parameters stay stacked along a leading L axis, as in the JAX
package; a Python loop over layers takes the place of its ``lax.scan``.
Public functions keep the JAX layouts: ``(B, S, vocab)`` f32 logits and a
cache whose ``kv`` leaves carry (L, B, ...) axes.  The training forward
(:func:`lm_forward`, :func:`lm_loss`) runs on dense weights; ``cfg.remat``
recomputes each block in the backward pass (``torch.utils.checkpoint``),
which changes no number.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.base import map_stacked
from repro_torch.quant.store import PackedWeight, is_store
from repro_torch.tree import tree_map


def _block_descs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.rmsnorm_desc(cfg.d_model),
        "attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                             qk_norm=cfg.qk_norm, dtype=cfg.dtype),
        "ln2": L.rmsnorm_desc(cfg.d_model),
        "mlp": L.mlp_descs(cfg.d_model, cfg.d_ff, dtype=cfg.dtype),
    }


def lm_descs(cfg: ArchConfig) -> dict:
    return {
        "embed": L.embed_descs(cfg.vocab, cfg.d_model, dtype=cfg.dtype),
        "final_norm": L.rmsnorm_desc(cfg.d_model),
        "blocks": map_stacked(cfg.n_layers, _block_descs(cfg)),
    }


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block params (views, no copies)."""

    def _take(a):
        if isinstance(a, PackedWeight):
            return a.layer(i)
        if is_store(a):
            raise ValueError("stacked QSQ leaves must be served (serve_tree) first")
        return a[i]

    return tree_map(_take, blocks, is_leaf=is_store)


def _block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = L.attention(p["attn"], L.rmsnorm(x, p["ln1"]), positions=positions,
                    theta=cfg.rope_theta, window=cfg.window)
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(x, p["ln2"]))


def lm_forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward: tokens (B, S) -> logits (B, S, vocab) f32.
    (The JAX package also returns a MoE aux loss, always 0 for dense.)"""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    # one unbind per stacked leaf: its backward stacks the L layer gradients
    # in one op, where L indexing selects would each add a full-size zero-
    # filled gradient (L^2 work); the values are the same either way
    stacks = tree_map(lambda a: a.unbind(0), params["blocks"])
    for i in range(cfg.n_layers):
        bp = tree_map(lambda t: t[i], stacks, is_leaf=lambda t: isinstance(t, tuple))
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_block_fwd, cfg, bp, x, positions, use_reentrant=False)
        else:
            x = _block_fwd(cfg, bp, x, positions)
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x)


def lm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy; batch = {tokens (B, S), labels (B, S)}."""
    return L.next_token_loss(lm_forward(params, cfg, batch["tokens"]), batch["labels"])


class LMCache(NamedTuple):
    kv: Any  # KVCache with leading (L,) stacked axis


def lm_cache_descs(cfg: ArchConfig, batch: int, cache_len: int) -> LMCache:
    return LMCache(kv=map_stacked(
        cfg.n_layers, L.kv_cache_descs(batch, cache_len, cfg.n_kv, cfg.hd, cfg.dtype)))


def _layer_cache(kv: L.KVCache, i: int) -> L.KVCache:
    return L.KVCache(k=kv.k[i], v=kv.v[i], pos=kv.pos[i], pad=kv.pad[i])


def lm_decode(params: dict, cfg: ArchConfig, cache: LMCache, tokens: torch.Tensor,
              active: torch.Tensor | None = None, tiers: torch.Tensor | None = None,
              demand: int | None = None) -> tuple[torch.Tensor, LMCache]:
    """One decode token per slot: tokens (B, 1) -> logits (B, 1, vocab) f32.
    The k/v of the new token are written into ``cache`` in place."""
    x = L.embed(params["embed"], tokens, cfg.dtype)
    kv = cache.kv
    pos = []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, c2 = L.decode_attention(
            bp["attn"], L.rmsnorm(x, bp["ln1"]), _layer_cache(kv, i),
            theta=cfg.rope_theta, window=cfg.window, active=active,
            tiers=tiers, demand=demand)
        x = x + h
        x = x + L.mlp(bp["mlp"], L.rmsnorm(x, bp["ln2"]), tiers=tiers, demand=demand)
        pos.append(c2.pos)
    x = L.rmsnorm(x, params["final_norm"])
    new_kv = L.KVCache(k=kv.k, v=kv.v, pos=torch.stack(pos), pad=kv.pad)
    return L.lm_head(params["embed"], x, tiers=tiers, demand=demand), LMCache(kv=new_kv)


def lm_prefill(params: dict, cfg: ArchConfig, cache: LMCache, tokens: torch.Tensor,
               lengths: torch.Tensor, tiers: torch.Tensor | None = None,
               demand: int | None = None) -> tuple[LMCache, torch.Tensor]:
    """One-pass cache prefill of left-padded prompts (B, S) with real
    lengths (B,): returns (a new primed cache, last-position logits (B, V))."""
    b, s = tokens.shape
    pad = (s - lengths).to(torch.int32)
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.clamp(
        torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :] - pad[:, None],
        min=0)
    ks, vs, pos, pads = [], [], [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, c2 = L.prefill_attention(
            bp["attn"], L.rmsnorm(x, bp["ln1"]), _layer_cache(cache.kv, i),
            positions=positions, pad=pad, theta=cfg.rope_theta, window=cfg.window,
            tiers=tiers, demand=demand)
        x = x + h
        x = x + L.mlp(bp["mlp"], L.rmsnorm(x, bp["ln2"]), tiers=tiers, demand=demand)
        ks.append(c2.k)
        vs.append(c2.v)
        pos.append(c2.pos)
        pads.append(c2.pad)
    x = L.rmsnorm(x[:, -1:], params["final_norm"])  # only the last position
    logits = L.lm_head(params["embed"], x, tiers=tiers, demand=demand)
    kv = L.KVCache(k=torch.stack(ks), v=torch.stack(vs), pos=torch.stack(pos),
                   pad=torch.stack(pads))
    return LMCache(kv=kv), logits[:, 0]


def lm_verify(params: dict, cfg: ArchConfig, cache: LMCache, tokens: torch.Tensor,
              start: torch.Tensor, wlen: torch.Tensor, spec: torch.Tensor,
              tiers: torch.Tensor | None = None,
              demand: int | None = None) -> tuple[torch.Tensor, LMCache]:
    """Batched multi-position forward for self-speculative verify: tokens
    (B, W) windows land at cache indices ``[start, start + wlen)`` of each
    lane (in place, over the draft-tier KV), at the lane's verify tier, and
    logits (B, W, vocab) f32 come back for every window position.  The
    packed matmuls run on the whole window (M = B x W), the norms and the
    attention position by position (``layers.per_position``), so every row
    is a decode step's, bit for bit.  ``spec`` marks the speculating lanes
    (it gates MoE capacity in the JAX package; the dense family does not
    read it)."""
    del spec
    if cfg.window is not None:
        raise ValueError("speculative verify requires a full-length KV cache")
    x = L.embed(params["embed"], tokens, cfg.dtype)
    kv = cache.kv
    pos = []
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        y = L.per_position(lambda r, s=bp["ln1"]: L.rmsnorm(r, s), x)
        h, c2 = L.verify_attention(bp["attn"], y, _layer_cache(kv, i), start=start, wlen=wlen,
                                   theta=cfg.rope_theta, tiers=tiers, demand=demand)
        x = x + h
        y = L.per_position(lambda r, s=bp["ln2"]: L.rmsnorm(r, s), x)
        x = x + L.mlp(bp["mlp"], y, tiers=tiers, demand=demand)
        pos.append(c2.pos)
    x = L.per_position(lambda r: L.rmsnorm(r, params["final_norm"]), x)
    new_kv = L.KVCache(k=kv.k, v=kv.v, pos=torch.stack(pos), pad=kv.pad)
    return L.lm_head(params["embed"], x, tiers=tiers, demand=demand), LMCache(kv=new_kv)


def lm_cache_insert_slot(live: LMCache, one: LMCache, slot: int) -> LMCache:
    """Admit a request: write a prefilled single-slot cache into lane
    ``slot`` of the live multi-slot cache, in place (batch is axis 1 of
    every ``kv`` leaf; axis 0 is the layer stack)."""
    for dst, src in zip(live.kv, one.kv, strict=True):
        dst[:, slot] = src[:, 0].to(dst.dtype)
    return live
