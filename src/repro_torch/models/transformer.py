"""Decoder-only LM: dense, MoE and VLM (the port of ``repro/models/transformer.py``).

Layer parameters stay stacked along a leading L axis, as in the JAX
package; a Python loop over layers takes the place of its ``lax.scan``.
Public functions keep the JAX layouts: ``(B, S, vocab)`` f32 logits and a
cache whose ``kv`` leaves carry (L, B, ...) axes.  The training forward
(:func:`lm_forward`, :func:`lm_loss`) runs on dense weights; ``cfg.remat``
recomputes each block in the backward pass (``torch.utils.checkpoint``),
which changes no number.  With ``cfg.moe`` set, each block's FFN is
``layers.moe`` and the loss adds its load-balancing term.

With ``cfg.cross_every`` set (the VLM, llama-3.2-vision), every group of
``cross_every`` layers is followed by a gated cross-attention block over
the vision tokens' K/V (``cross_blocks``, stacked on their own axis).  The
forward fills those K/V from ``vision_embeds`` once per cross block; the
decode reads them from ``LMCache.cross_kv``, which
:func:`vision_prefill_cross_kv` fills (zeros otherwise, as the engine
builds its cache).  The gates start at zero, so a freshly initialised
cross block is the identity.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import verify_row_blocks
from repro_torch.models import layers as L
from repro_torch.models.base import ParamDesc, map_stacked
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


def _cross_block_descs(cfg: ArchConfig) -> dict:
    return {
        "ln": L.rmsnorm_desc(cfg.d_model),
        "attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                             qk_norm=cfg.qk_norm, dtype=cfg.dtype),
        "gate": ParamDesc((1,), (None,), init="zeros"),
        "ln_mlp": L.rmsnorm_desc(cfg.d_model),
        "mlp": L.mlp_descs(cfg.d_model, cfg.d_ff, dtype=cfg.dtype),
        "gate_mlp": ParamDesc((1,), (None,), init="zeros"),
    }


def lm_descs(cfg: ArchConfig) -> dict:
    descs = {
        "embed": L.embed_descs(cfg.vocab, cfg.d_model, dtype=cfg.dtype),
        "final_norm": L.rmsnorm_desc(cfg.d_model),
        "blocks": map_stacked(cfg.n_layers, _block_descs(cfg)),
    }
    if cfg.cross_every:
        descs["cross_blocks"] = map_stacked(_n_cross(cfg), _cross_block_descs(cfg))
    return descs


def _n_cross(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.cross_every:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups of "
                         f"cross_every={cfg.cross_every}")
    return cfg.n_layers // cfg.cross_every


def _take(a, i: int):
    if isinstance(a, PackedWeight):
        return a.layer(i)
    if is_store(a):
        raise ValueError("stacked QSQ leaves must be served (serve_tree) first")
    return a[i]


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block params (views, no copies)."""
    return tree_map(lambda a: _take(a, i), blocks, is_leaf=is_store)


def _layer_views(blocks: dict):
    """i -> layer i of the stacked block params, for the training forward:
    each stacked tensor is unbound once (its backward then stacks the L
    layer gradients in one op, where L indexing selects would each add a
    full-size zero-filled gradient: L^2 work; the values are the same
    either way); packed leaves are sliced with ``layer``."""
    stacks = tree_map(lambda a: a if is_store(a) else a.unbind(0), blocks, is_leaf=is_store)

    def at(i: int) -> dict:
        return tree_map(lambda t: _take(t, i), stacks,
                        is_leaf=lambda t: isinstance(t, tuple) or is_store(t))

    return at


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


def _cross_block_fwd(p: dict, x: torch.Tensor, kv) -> torch.Tensor:
    """The gated cross block: cross attention over ``kv``, then the MLP,
    each scaled by ``tanh`` of its gate.  Its matmuls run at the engine's
    tier (no per-row tiers), as in the JAX package."""
    h = L.cross_attention(p["attn"], L.rmsnorm(x, p["ln"]), kv)
    x = x + torch.tanh(p["gate"]).to(x.dtype) * h
    f = L.mlp(p["mlp"], L.rmsnorm(x, p["ln_mlp"]))
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * f


def lm_forward_aux(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   vision_embeds: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training / prefill forward: tokens (B, S) [and, for the VLM, the
    vision embeddings (B, T_img, d)] -> (logits (B, S, vocab) f32, the MoE
    aux loss summed over layers and divided by ``n_layers``; 0 for dense),
    as the JAX package's ``lm_forward`` returns them."""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    layer = _layer_views(params["blocks"])
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    cross = []  # (params, K/V) of each cross block, its K/V filled once
    if cfg.cross_every:
        cross_at = _layer_views(params["cross_blocks"])
        for g in range(_n_cross(cfg)):
            cp = cross_at(g)
            cross.append((cp, L.cross_kv(cp["attn"], vision_embeds)))
    for i in range(cfg.n_layers):
        bp = layer(i)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(_block_fwd, cfg, bp, x, positions, use_reentrant=False)
        else:
            x, a = _block_fwd(cfg, bp, x, positions)
        if a is not None:
            aux = aux + a
        if cross and (i + 1) % cfg.cross_every == 0:
            cp, ckv = cross[i // cfg.cross_every]
            x = _cross_block_fwd(cp, x, ckv)
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), aux / cfg.n_layers


def lm_forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
               vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Training / prefill forward: tokens (B, S) -> logits (B, S, vocab) f32."""
    return lm_forward_aux(params, cfg, tokens, vision_embeds)[0]


def lm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy plus 0.01 x the MoE aux loss; batch =
    {tokens (B, S), labels (B, S)[, vision_embeds (B, T_img, d)]}."""
    logits, aux = lm_forward_aux(params, cfg, batch["tokens"], batch.get("vision_embeds"))
    return L.next_token_loss(logits, batch["labels"]) + 0.01 * aux


class LMCache(NamedTuple):
    kv: Any  # KVCache with leading (L,) stacked axis
    cross_kv: Any = None  # the VLM's (k, v), each (n_cross, B, T_img, Kv, hd)


def lm_cache_descs(cfg: ArchConfig, batch: int, cache_len: int) -> LMCache:
    """The decode cache of ``cache_len`` logical positions; with a sliding
    window its physical length is ``min(cache_len, window)`` (a ring).  The
    VLM's also holds the cross K/V of every cross block, zero-initialised."""
    t = min(cache_len, cfg.window) if cfg.window else cache_len
    kv = map_stacked(cfg.n_layers, L.kv_cache_descs(batch, t, cfg.n_kv, cfg.hd, cfg.dtype))
    cross = None
    if cfg.cross_every:
        ck = ParamDesc((_n_cross(cfg), batch, cfg.vision_tokens, cfg.n_kv, cfg.hd),
                       (None, "batch", None, "kv_heads", None), dtype=cfg.dtype, init="zeros")
        cross = (ck, ck)
    return LMCache(kv=kv, cross_kv=cross)


def _layer_cache(kv: L.KVCache, i: int) -> L.KVCache:
    return L.KVCache(k=kv.k[i], v=kv.v[i], pos=kv.pos[i], pad=kv.pad[i])


def lm_decode(params: dict, cfg: ArchConfig, cache: LMCache, tokens: torch.Tensor,
              active: torch.Tensor | None = None, tiers: torch.Tensor | None = None,
              demand: int | None = None) -> tuple[torch.Tensor, LMCache]:
    """One decode token per slot: tokens (B, 1) -> logits (B, 1, vocab) f32.
    The k/v of the new token and the advanced ``pos`` are written into
    ``cache`` in place, which comes back as it went in.  ``active``,
    ``tiers`` and ``demand`` reach the self-attention layers and the head;
    the VLM's cross blocks read ``cache.cross_kv`` at the engine's tier."""
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
        if cfg.cross_every and (i + 1) % cfg.cross_every == 0:
            g = i // cfg.cross_every
            ck, cv = cache.cross_kv
            x = _cross_block_fwd(layer_params(params["cross_blocks"], g), x, (ck[g], cv[g]))
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
    if cfg.cross_every:
        raise ValueError("speculative verify requires an attention-only stack")
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


def vision_prefill_cross_kv(params: dict, cfg: ArchConfig,
                            vision_embeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode cache's cross K/V of ``vision_embeds`` (B, T_img, d):
    (k, v), each (n_cross, B, T_img, Kv, hd), one :func:`layers.cross_kv`
    per cross block."""
    kvs = [L.cross_kv(layer_params(params["cross_blocks"], g)["attn"], vision_embeds)
           for g in range(_n_cross(cfg))]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])
