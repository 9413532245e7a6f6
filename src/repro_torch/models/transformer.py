"""Decoder-only LM, dense and MoE (the port of ``repro/models/transformer.py``).

Layer parameters stay stacked along a leading L axis, as in the JAX
package; a Python loop over layers takes the place of its ``lax.scan``.
Public functions keep the JAX layouts: ``(B, S, vocab)`` f32 logits and a
cache whose ``kv`` leaves carry (L, B, ...) axes.  The training forward
(:func:`lm_forward`, :func:`lm_loss`) runs on dense weights; ``cfg.remat``
recomputes each block in the backward pass (``torch.utils.checkpoint``),
which changes no number.  With ``cfg.moe`` set, each block's FFN is
``layers.moe`` and the loss adds its load-balancing term.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import verify_row_blocks
from repro_torch.models import layers as L
from repro_torch.models.base import map_stacked
from repro_torch.quant.store import PackedWeight, is_store
from repro_torch.tree import tree_map


def _block_descs(cfg: ArchConfig) -> dict:
    d = {
        "ln1": L.rmsnorm_desc(cfg.d_model),
        "attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                             qk_norm=cfg.qk_norm, dtype=cfg.dtype),
        "ln2": L.rmsnorm_desc(cfg.d_model),
    }
    if cfg.moe is not None:
        d["moe"] = L.moe_descs(cfg.d_model, cfg.d_ff, cfg.moe.n_experts, dtype=cfg.dtype)
    else:
        d["mlp"] = L.mlp_descs(cfg.d_model, cfg.d_ff, dtype=cfg.dtype)
    return d


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


def _ffn(cfg: ArchConfig, p: dict, y: torch.Tensor, active=None, tiers=None,
         demand=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN over the normed y -> (out, MoE aux loss or None).
    The experts are dense, so ``tiers``/``demand`` reach only the MLP; MoE
    lanes that ``active`` marks dead leave the expert competition."""
    if cfg.moe is not None:
        return L.moe(p["moe"], y, top_k=cfg.moe.top_k,
                     capacity_factor=cfg.moe.capacity_factor, active=active)
    return L.mlp(p["mlp"], y, tiers=tiers, demand=demand), None


def _block_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    h = L.attention(p["attn"], L.rmsnorm(x, p["ln1"]), positions=positions,
                    theta=cfg.rope_theta, window=cfg.window)
    x = x + h
    f, aux = _ffn(cfg, p, L.rmsnorm(x, p["ln2"]))
    return x + f, aux


def lm_forward_aux(params: dict, cfg: ArchConfig,
                   tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Training / prefill forward: tokens (B, S) -> (logits (B, S, vocab) f32,
    the MoE aux loss averaged over layers; 0 for dense), as the JAX
    package's ``lm_forward`` returns them."""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    # one unbind per stacked leaf: its backward stacks the L layer gradients
    # in one op, where L indexing selects would each add a full-size zero-
    # filled gradient (L^2 work); the values are the same either way
    stacks = tree_map(lambda a: a.unbind(0), params["blocks"])
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        bp = tree_map(lambda t: t[i], stacks, is_leaf=lambda t: isinstance(t, tuple))
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_block_fwd, cfg, bp, x, positions, use_reentrant=False)
        else:
            x, a = _block_fwd(cfg, bp, x, positions)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), aux / cfg.n_layers


def lm_forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward: tokens (B, S) -> logits (B, S, vocab) f32."""
    return lm_forward_aux(params, cfg, tokens)[0]


def lm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy plus 0.01 x the MoE aux loss; batch =
    {tokens (B, S), labels (B, S)}."""
    logits, aux = lm_forward_aux(params, cfg, batch["tokens"])
    return L.next_token_loss(logits, batch["labels"]) + 0.01 * aux


class LMCache(NamedTuple):
    kv: Any  # KVCache with leading (L,) stacked axis


def lm_cache_descs(cfg: ArchConfig, batch: int, cache_len: int) -> LMCache:
    """The decode cache of ``cache_len`` logical positions; with a sliding
    window its physical length is ``min(cache_len, window)`` (a ring)."""
    t = min(cache_len, cfg.window) if cfg.window else cache_len
    return LMCache(kv=map_stacked(
        cfg.n_layers, L.kv_cache_descs(batch, t, cfg.n_kv, cfg.hd, cfg.dtype)))


def _layer_cache(kv: L.KVCache, i: int) -> L.KVCache:
    return L.KVCache(k=kv.k[i], v=kv.v[i], pos=kv.pos[i], pad=kv.pad[i])


def lm_decode(params: dict, cfg: ArchConfig, cache: LMCache, tokens: torch.Tensor,
              active: torch.Tensor | None = None, tiers: torch.Tensor | None = None,
              demand: int | None = None) -> tuple[torch.Tensor, LMCache]:
    """One decode token per slot: tokens (B, 1) -> logits (B, 1, vocab) f32.
    The k/v of the new token and the advanced ``pos`` are written into
    ``cache`` in place, which comes back as it went in."""
    x = L.embed(params["embed"], tokens, cfg.dtype)
    kv = cache.kv
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, _ = L.decode_attention(
            bp["attn"], L.rmsnorm(x, bp["ln1"]), _layer_cache(kv, i),
            theta=cfg.rope_theta, window=cfg.window, active=active,
            tiers=tiers, demand=demand)
        x = x + h
        x = x + _ffn(cfg, bp, L.rmsnorm(x, bp["ln2"]), active, tiers, demand)[0]
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x, tiers=tiers, demand=demand), cache


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
        # no lane mask: left-pad positions route too, as in the JAX package
        x = x + _ffn(cfg, bp, L.rmsnorm(x, bp["ln2"]), None, tiers, demand)[0]
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
    lane (in place, over the draft-tier KV, ``pos`` too), at the lane's
    verify tier, and logits (B, W, vocab) f32 come back for every window
    position.  The
    packed matmuls run on the whole window (M = B x W, launched in row
    blocks of at most ``SAME_PLAN_ROWS``, each with the GEMV's split), the
    norms and the attention position by position (``layers.per_position``),
    so every row is a decode step's, bit for bit.  ``spec`` marks the
    speculating lanes: a MoE block routes the whole (B, W) window in one
    call with the other lanes out of the competition, so its capacity is
    set by B x W, as in the JAX package (the dense family does not read
    it)."""
    if cfg.window is not None:
        raise ValueError("speculative verify requires a full-length KV cache")
    with verify_row_blocks():
        return _verify(params, cfg, cache, tokens, start, wlen, tiers, demand, spec)


def _verify(params, cfg, cache, tokens, start, wlen, tiers, demand, spec=None):
    x = L.embed(params["embed"], tokens, cfg.dtype)
    kv = cache.kv
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        y = L.per_position(lambda r, s=bp["ln1"]: L.rmsnorm(r, s), x)
        h, _ = L.verify_attention(bp["attn"], y, _layer_cache(kv, i), start=start, wlen=wlen,
                                  theta=cfg.rope_theta, tiers=tiers, demand=demand)
        x = x + h
        y = L.per_position(lambda r, s=bp["ln2"]: L.rmsnorm(r, s), x)
        x = x + _ffn(cfg, bp, y, spec, tiers, demand)[0]
    x = L.per_position(lambda r: L.rmsnorm(r, params["final_norm"]), x)
    return L.lm_head(params["embed"], x, tiers=tiers, demand=demand), cache


def lm_cache_insert_slot(live: LMCache, one: LMCache, slot) -> LMCache:
    """Admit a request: write a prefilled single-slot cache into lane
    ``slot`` of the live multi-slot cache, in place (batch is axis 1 of
    every ``kv`` leaf; axis 0 is the layer stack).  ``slot`` is an int or
    a one-element device tensor, the JAX package's traced scalar: the
    engine's admission then replays one captured graph for every lane."""
    idx = torch.as_tensor(slot, device=live.kv.k.device).reshape(1).to(torch.int64)
    for dst, src in zip(live.kv, one.kv, strict=True):
        dst.index_copy_(1, idx, src.to(dst.dtype))
    return live
