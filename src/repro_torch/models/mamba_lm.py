"""Pure Mamba2 LM, attention-free (the port of ``repro/models/mamba_lm.py``):
embed -> N x (norm + SSD mixer) -> head.

The layer scan is a loop over :func:`transformer.layer_params`, so packed
stacked leaves are sliced per layer as views.  Decode writes each layer's
recurrent state into the cache in place; the cache keeps the JAX layout,
``MambaCache(ssm=SSMState)`` with a leading (L,) axis on every leaf.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.base import map_stacked
from repro_torch.models.transformer import layer_params


def _ssm_cfg(cfg: ArchConfig) -> S.SSMConfig:
    d_inner = 2 * cfg.d_model
    return S.SSMConfig(
        d_model=cfg.d_model,
        d_inner=d_inner,
        n_heads=d_inner // cfg.ssm_head_dim,
        head_dim=cfg.ssm_head_dim,
        state=cfg.ssm_state,
        n_groups=cfg.ssm_groups,
        chunk=cfg.ssm_chunk,
    )


def mamba_descs(cfg: ArchConfig) -> dict:
    sc = _ssm_cfg(cfg)
    block = {"ln": L.rmsnorm_desc(cfg.d_model), "mixer": S.ssm_descs(sc, dtype=cfg.dtype)}
    return {
        "embed": L.embed_descs(cfg.vocab, cfg.d_model, dtype=cfg.dtype),
        "final_norm": L.rmsnorm_desc(cfg.d_model),
        "blocks": map_stacked(cfg.n_layers, block),
    }


def _block(sc: S.SSMConfig, bp: dict, x: torch.Tensor) -> torch.Tensor:
    return x + S.ssm_forward(bp["mixer"], L.rmsnorm(x, bp["ln"]), sc)


def mamba_forward(params: dict, cfg: ArchConfig,
                  tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, vocab) f32, aux loss 0)."""
    sc = _ssm_cfg(cfg)
    x = L.embed(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_block, sc, bp, x, use_reentrant=False)
        else:
            x = _block(sc, bp, x)
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), torch.zeros((), dtype=torch.float32,
                                                      device=tokens.device)


def mamba_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    logits, _ = mamba_forward(params, cfg, batch["tokens"])
    return L.next_token_loss(logits, batch["labels"])


class MambaCache(NamedTuple):
    ssm: Any  # SSMState stacked (L, ...)


def mamba_cache_descs(cfg: ArchConfig, batch: int, cache_len: int) -> MambaCache:
    """The recurrent state: constant in ``cache_len``."""
    sc = _ssm_cfg(cfg)
    return MambaCache(ssm=map_stacked(cfg.n_layers, S.ssm_state_descs(sc, batch, cfg.dtype)))


def mamba_decode(params: dict, cfg: ArchConfig, cache: MambaCache,
                 tokens: torch.Tensor) -> tuple[torch.Tensor, MambaCache]:
    """One token per slot: tokens (B, 1) -> logits (B, 1, vocab) f32; the
    states advance in place and ``cache`` comes back as it went in."""
    sc = _ssm_cfg(cfg)
    x = L.embed(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, _ = S.ssm_decode(bp["mixer"], L.rmsnorm(x, bp["ln"]), S.state_at(cache.ssm, i), sc)
        x = x + h
    x = L.rmsnorm(x, params["final_norm"])
    return L.lm_head(params["embed"], x), cache
