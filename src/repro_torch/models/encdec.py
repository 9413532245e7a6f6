"""Whisper-style encoder-decoder transformer (the port of ``repro/models/encdec.py``,
arXiv:2212.04356).

The conv/mel front end is a stub, as in the JAX package: the caller passes
precomputed frame embeddings (B, enc_seq, d_model).  RMSNorm stands in for
LayerNorm and the MLP is the paper's two-layer GELU (tanh approximation,
``jax.nn.gelu``'s default), contracted against ``layers.W``'s dense decode
of its weights, never through :func:`layers.matvec`, as the JAX package
contracts it.  Positions are absolute sinusoids, no RoPE: the forward adds
the numpy table (:func:`layers.sinusoidal_pos_emb`), the decode computes
the rows of its positions on the device (:func:`_sin_pos_at`).

The decode cache keeps the JAX layout, ``EncDecCache(kv, cross_k,
cross_v)`` with a leading (L_dec,) axis on every leaf; the self-attention
K/V and ``pos`` are written in place, the cross K/V (filled by
:func:`encdec_prefill_cross`, zeros otherwise) only read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.base import ParamDesc, dense, map_stacked
from repro_torch.models.transformer import _layer_cache, _layer_views, layer_params


def _gelu_mlp_descs(d: int, ff: int, dtype) -> dict:
    return {"wi": dense(d, ff, "embed", "mlp", dtype=dtype),
            "wo": dense(ff, d, "mlp", "embed", dtype=dtype)}


def _gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ L.W(p["wi"]).to(x.dtype), approximate="tanh")
    return h @ L.W(p["wo"]).to(x.dtype)


def _enc_block_descs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.rmsnorm_desc(cfg.d_model),
        "attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype=cfg.dtype),
        "ln2": L.rmsnorm_desc(cfg.d_model),
        "mlp": _gelu_mlp_descs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def _dec_block_descs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.rmsnorm_desc(cfg.d_model),
        "self_attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype=cfg.dtype),
        "ln_x": L.rmsnorm_desc(cfg.d_model),
        "cross_attn": L.attn_descs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype=cfg.dtype),
        "ln2": L.rmsnorm_desc(cfg.d_model),
        "mlp": _gelu_mlp_descs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def encdec_descs(cfg: ArchConfig) -> dict:
    return {
        "embed": L.embed_descs(cfg.vocab, cfg.d_model, dtype=cfg.dtype),
        "enc_blocks": map_stacked(cfg.enc_layers, _enc_block_descs(cfg)),
        "dec_blocks": map_stacked(cfg.n_layers, _dec_block_descs(cfg)),
        "enc_norm": L.rmsnorm_desc(cfg.d_model),
        "final_norm": L.rmsnorm_desc(cfg.d_model),
    }


def _pos_table(s: int, cfg: ArchConfig, device) -> torch.Tensor:
    return torch.from_numpy(L.sinusoidal_pos_emb(s, cfg.d_model)).to(device, cfg.dtype)


def _enc_block(bp: dict, x: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(bp["attn"], L.rmsnorm(x, bp["ln1"]), positions=None, causal=False)
    return x + _gelu_mlp(bp["mlp"], L.rmsnorm(x, bp["ln2"]))


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, enc_seq, d) precomputed embeddings (the stub front end) ->
    the normed encoder output (B, enc_seq, d)."""
    x = frames.to(cfg.dtype) + _pos_table(frames.shape[1], cfg, frames.device)[None]
    layer = _layer_views(params["enc_blocks"])
    for i in range(cfg.enc_layers):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_enc_block, layer(i), x, use_reentrant=False)
        else:
            x = _enc_block(layer(i), x)
    return L.rmsnorm(x, params["enc_norm"])


def _dec_block(bp: dict, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(bp["self_attn"], L.rmsnorm(x, bp["ln1"]), positions=None, causal=True)
    ckv = L.cross_kv(bp["cross_attn"], enc)
    x = x + L.cross_attention(bp["cross_attn"], L.rmsnorm(x, bp["ln_x"]), ckv)
    return x + _gelu_mlp(bp["mlp"], L.rmsnorm(x, bp["ln2"]))


def encdec_forward(params: dict, cfg: ArchConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: frames (B, enc_seq, d), tokens (B, S) ->
    (logits (B, S, vocab) f32, aux loss 0)."""
    enc = encode(params, cfg, frames)
    x = L.embed(params["embed"], tokens, cfg.dtype) + _pos_table(
        tokens.shape[1], cfg, tokens.device)[None]
    layer = _layer_views(params["dec_blocks"])
    for i in range(cfg.n_layers):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_dec_block, layer(i), x, enc, use_reentrant=False)
        else:
            x = _dec_block(layer(i), x, enc)
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), torch.zeros((), dtype=torch.float32,
                                                      device=tokens.device)


def encdec_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token loss; batch = {frames (B, enc_seq, d), tokens, labels (B, S)}."""
    logits, _ = encdec_forward(params, cfg, batch["frames"], batch["tokens"])
    return L.next_token_loss(logits, batch["labels"])


class EncDecCache(NamedTuple):
    kv: Any  # the decoder's self-attention KVCache, stacked (L_dec, ...)
    cross_k: Any  # (L_dec, B, enc_seq, Kv, hd)
    cross_v: Any


def encdec_cache_descs(cfg: ArchConfig, batch: int, cache_len: int) -> EncDecCache:
    ck = ParamDesc((cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv, cfg.hd),
                   (None, "batch", None, "kv_heads", None), dtype=cfg.dtype, init="zeros")
    return EncDecCache(
        kv=map_stacked(cfg.n_layers, L.kv_cache_descs(batch, cache_len, cfg.n_kv, cfg.hd,
                                                      cfg.dtype)),
        cross_k=ck,
        cross_v=ck,
    )


def encdec_prefill_cross(params: dict, cfg: ArchConfig,
                         frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder pass and every decoder layer's cross K/V (once a
    request): (k, v), each (L_dec, B, enc_seq, Kv, hd)."""
    enc = encode(params, cfg, frames)
    kvs = [L.cross_kv(layer_params(params["dec_blocks"], i)["cross_attn"], enc)
           for i in range(cfg.n_layers)]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _sin_pos_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The sinusoid rows (B, d) of positions ``pos`` (B,), computed in f32 on
    their device in the JAX package's order of operations."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.to(torch.float32)[..., None] / torch.pow(10000.0, 2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encdec_decode(params: dict, cfg: ArchConfig, cache: EncDecCache,
                  tokens: torch.Tensor) -> tuple[torch.Tensor, EncDecCache]:
    """One token per slot: tokens (B, 1) -> logits (B, 1, vocab) f32.  The
    position of each slot is its layer-0 ``pos``; the self-attention K/V
    and ``pos`` advance in place and ``cache`` comes back as it went in."""
    pos = _sin_pos_at(cache.kv.pos[0], cfg.d_model, cfg.dtype)  # (B, d)
    x = L.embed(params["embed"], tokens, cfg.dtype) + pos[:, None, :]
    for i in range(cfg.n_layers):
        bp = layer_params(params["dec_blocks"], i)
        # absolute sinusoidal positions, no RoPE (as in the encoder)
        h, _ = L.decode_attention(bp["self_attn"], L.rmsnorm(x, bp["ln1"]),
                                  _layer_cache(cache.kv, i), use_rope=False)
        x = x + h
        x = x + L.cross_attention(bp["cross_attn"], L.rmsnorm(x, bp["ln_x"]),
                                  (cache.cross_k[i], cache.cross_v[i]))
        x = x + _gelu_mlp(bp["mlp"], L.rmsnorm(x, bp["ln2"]))
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), cache
