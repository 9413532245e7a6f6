"""Jamba-style hybrid (the port of ``repro/models/hybrid.py``), arXiv:2403.19887:
blocks of ``period`` layers = 1 attention + (period - 1) Mamba2 mixers, an
FFN after every mixer, MoE where ``i % moe_every == 1`` and dense
otherwise.

The loop runs over the (n_layers // period) blocks; the sublayers inside a
block are unrolled.  The mamba, norm and FFN leaves of a block are stacked
twice, (n_blocks, period - 1 or n_dense or n_moe, ...), so a packed leaf
is sliced twice with ``PackedWeight.layer`` (:func:`transformer.layer_params`).
Decode writes the attention KV and the recurrent states into the cache in
place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.base import map_stacked
from repro_torch.models.mamba_lm import _ssm_cfg
from repro_torch.models.transformer import _layer_cache, layer_params


def _ffn_counts(cfg: ArchConfig) -> tuple[int, int]:
    period = cfg.hybrid.period
    n_moe = sum(1 for i in range(period) if i % cfg.hybrid.moe_every == 1)
    return period - n_moe, n_moe  # (dense, moe)


def hybrid_descs(cfg: ArchConfig) -> dict:
    period = cfg.hybrid.period
    n_blocks = cfg.n_layers // period
    sc = _ssm_cfg(cfg)
    n_dense, n_moe = _ffn_counts(cfg)
    block = {
        "attn_ln": L.rmsnorm_desc(cfg.d_model),
        "attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype=cfg.dtype),
        "mamba_ln": map_stacked(period - 1, L.rmsnorm_desc(cfg.d_model), None),
        "mamba": map_stacked(period - 1, S.ssm_descs(sc, dtype=cfg.dtype), None),
        "ffn_ln": map_stacked(period, L.rmsnorm_desc(cfg.d_model), None),
        "dense_ffn": map_stacked(n_dense, L.mlp_descs(cfg.d_model, cfg.d_ff, dtype=cfg.dtype),
                                 None),
        "moe_ffn": map_stacked(n_moe, L.moe_descs(cfg.d_model, cfg.d_ff, cfg.moe.n_experts,
                                                  dtype=cfg.dtype), None),
    }
    return {
        "embed": L.embed_descs(cfg.vocab, cfg.d_model, dtype=cfg.dtype),
        "final_norm": L.rmsnorm_desc(cfg.d_model),
        "blocks": map_stacked(n_blocks, block),
    }


def _ffn(cfg: ArchConfig, bp: dict, x: torch.Tensor,
         layer_in_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """FFN of sublayer i: MoE (index i // moe_every) if i % moe_every == 1,
    else dense (index (i + 1) // moe_every) -> (x + ffn, aux loss)."""
    y = L.rmsnorm(x, bp["ffn_ln"][layer_in_block])
    if layer_in_block % cfg.hybrid.moe_every == 1:
        f, aux = L.moe(layer_params(bp["moe_ffn"], layer_in_block // cfg.hybrid.moe_every), y,
                       top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor)
    else:
        dense_idx = (layer_in_block + 1) // cfg.hybrid.moe_every
        f = L.mlp(layer_params(bp["dense_ffn"], dense_idx), y)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def _block_fwd(cfg: ArchConfig, bp: dict, x: torch.Tensor, aux: torch.Tensor,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sc = _ssm_cfg(cfg)
    h = L.attention(bp["attn"], L.rmsnorm(x, bp["attn_ln"]), positions=positions,
                    theta=cfg.rope_theta)
    x, a = _ffn(cfg, bp, x + h, 0)
    aux = aux + a
    for i in range(1, cfg.hybrid.period):
        h = S.ssm_forward(layer_params(bp["mamba"], i - 1),
                          L.rmsnorm(x, bp["mamba_ln"][i - 1]), sc)
        x, a = _ffn(cfg, bp, x + h, i)
        aux = aux + a
    return x, aux


def hybrid_forward(params: dict, cfg: ArchConfig,
                   tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, vocab) f32, MoE aux loss / n_layers)."""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in range(cfg.n_layers // cfg.hybrid.period):
        bp = layer_params(params["blocks"], blk)
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block_fwd, cfg, bp, x, aux, positions, use_reentrant=False)
        else:
            x, aux = _block_fwd(cfg, bp, x, aux, positions)
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), aux / cfg.n_layers


def hybrid_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    logits, aux = hybrid_forward(params, cfg, batch["tokens"])
    return L.next_token_loss(logits, batch["labels"]) + 0.01 * aux


class HybridCache(NamedTuple):
    kv: Any  # KVCache stacked (n_blocks, ...)
    ssm: Any  # SSMState stacked (n_blocks, period - 1, ...)


def hybrid_cache_descs(cfg: ArchConfig, batch: int, cache_len: int) -> HybridCache:
    period = cfg.hybrid.period
    n_blocks = cfg.n_layers // period
    sc = _ssm_cfg(cfg)
    t = min(cache_len, cfg.window) if cfg.window else cache_len
    return HybridCache(
        kv=map_stacked(n_blocks, L.kv_cache_descs(batch, t, cfg.n_kv, cfg.hd, cfg.dtype)),
        ssm=map_stacked(n_blocks, map_stacked(period - 1,
                                              S.ssm_state_descs(sc, batch, cfg.dtype), None)),
    )


def hybrid_decode(params: dict, cfg: ArchConfig, cache: HybridCache,
                  tokens: torch.Tensor) -> tuple[torch.Tensor, HybridCache]:
    """One token per slot: tokens (B, 1) -> logits (B, 1, vocab) f32; the KV
    entries, ``pos`` and the recurrent states advance in place."""
    sc = _ssm_cfg(cfg)
    x = L.embed(params["embed"], tokens, cfg.dtype)
    for blk in range(cfg.n_layers // cfg.hybrid.period):
        bp = layer_params(params["blocks"], blk)
        h, _ = L.decode_attention(bp["attn"], L.rmsnorm(x, bp["attn_ln"]),
                                  _layer_cache(cache.kv, blk),
                                  theta=cfg.rope_theta, window=cfg.window)
        x, _ = _ffn(cfg, bp, x + h, 0)
        states = S.state_at(cache.ssm, blk)
        for i in range(1, cfg.hybrid.period):
            h, _ = S.ssm_decode(layer_params(bp["mamba"], i - 1),
                                L.rmsnorm(x, bp["mamba_ln"][i - 1]), S.state_at(states, i - 1),
                                sc)
            x, _ = _ffn(cfg, bp, x + h, i)
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), cache
