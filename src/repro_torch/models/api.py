"""Uniform model API (the port of ``repro/models/api.py``): the dense and MoE
decoders, the VLM (``vlm``, gated cross-attention blocks), the Mamba2 LM
(``ssm``), the Jamba hybrid (``hybrid``) and the Whisper-style
encoder-decoder (``encdec``).

The dense and MoE families prime their caches with one fused prefill and
serve on the continuous scheduler.  The others scan their prompts token by
token and serve one tier per engine through ``generate()``'s static path;
they refuse lane admission, and all but the VLM refuse per-slot masks and
tiers and verify, as in the JAX package (the VLM decodes with per-slot
tiers at the model level, and its verify raises in ``lm_verify``).  The
cross-attending families read cross K/V from their caches: zeros as the
engine builds them, or filled ahead of time by
``transformer.vision_prefill_cross_kv`` / ``encdec.encdec_prefill_cross``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, mamba_lm, transformer
from repro_torch.models.base import ParamDesc

_ATTENTION = ("dense", "moe", "vlm")
_FAMILIES = _ATTENTION + ("ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family} (the paper's CNNs are "
                             f"repro_torch.models.cnn, not a Model)")

    @property
    def fused_prefill(self) -> bool:
        """True if the family primes its cache with ONE full-sequence forward
        (attention-only stacks); ``train.step.supports_fused_prefill`` asks
        this.  Read here, not through the train package, so a captured
        admission (``cache_insert_slot``) runs no step-module code."""
        return self.cfg.family in ("dense", "moe") and not self.cfg.cross_every

    def param_descs(self):
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.mamba_descs(self.cfg)
        if f == "hybrid":
            return hybrid.hybrid_descs(self.cfg)
        if f == "encdec":
            return encdec.encdec_descs(self.cfg)
        return transformer.lm_descs(self.cfg)

    def loss(self, params, batch):
        """Scalar next-token loss; batch = {tokens (B, S), labels (B, S)}, with
        ``vision_embeds`` (B, T_img, d) for the VLM and ``frames`` (B,
        enc_seq, d) for the encoder-decoder."""
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.mamba_loss(params, self.cfg, batch)
        if f == "hybrid":
            return hybrid.hybrid_loss(params, self.cfg, batch)
        if f == "encdec":
            return encdec.encdec_loss(params, self.cfg, batch)
        return transformer.lm_loss(params, self.cfg, batch)

    def forward(self, params, batch):
        """Logits (B, S, vocab) f32 for batch = {tokens (B, S)}, with
        ``vision_embeds`` for the VLM and ``frames`` for the encoder-decoder."""
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.mamba_forward(params, self.cfg, batch["tokens"])[0]
        if f == "hybrid":
            return hybrid.hybrid_forward(params, self.cfg, batch["tokens"])[0]
        if f == "encdec":
            return encdec.encdec_forward(params, self.cfg, batch["frames"], batch["tokens"])[0]
        return transformer.lm_forward(params, self.cfg, batch["tokens"],
                                      batch.get("vision_embeds"))

    def cache_descs(self, batch: int, cache_len: int):
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.mamba_cache_descs(self.cfg, batch, cache_len)
        if f == "hybrid":
            return hybrid.hybrid_cache_descs(self.cfg, batch, cache_len)
        if f == "encdec":
            return encdec.encdec_cache_descs(self.cfg, batch, cache_len)
        return transformer.lm_cache_descs(self.cfg, batch, cache_len)

    def decode(self, params, cache, batch):
        """One decode step; batch = {tokens (B,1), [active, tiers, demand]}
        (the bracketed keys: the dense, MoE and VLM families only)."""
        f = self.cfg.family
        tokens = batch["tokens"]
        active, tiers, demand = batch.get("active"), batch.get("tiers"), batch.get("demand")
        if f in _ATTENTION:
            return transformer.lm_decode(params, self.cfg, cache, tokens, active=active,
                                         tiers=tiers, demand=demand)
        if active is not None or tiers is not None or demand is not None:
            raise ValueError(
                f"per-slot active masks / quality tiers (continuous batching) are only "
                f"supported by attention families, not {f!r}")
        if f == "ssm":
            return mamba_lm.mamba_decode(params, self.cfg, cache, tokens)
        if f == "hybrid":
            return hybrid.hybrid_decode(params, self.cfg, cache, tokens)
        return encdec.encdec_decode(params, self.cfg, cache, tokens)

    def prefill(self, params, cache, tokens, lengths=None, tiers=None, demand=None):
        """Prime a decode cache for whole (B, S) left-padded prompts ->
        (cache, last_logits).  Attention families run one full-sequence
        pass; recurrent ones scan the prompt token by token (``lengths``
        unused: left pads pass through the recurrent state)."""
        from repro_torch.train.step import make_cache_prefill_step

        if lengths is None:
            lengths = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        return make_cache_prefill_step(self)(params, cache, tokens, lengths, tiers, demand)

    def verify(self, params, cache, batch):
        """Batched multi-position forward for self-speculative verify: each
        lane's window ``[start, start + wlen)`` scored in one pass at the
        lane's verify tier -> (logits (B, W, V) f32, cache).  The dense and
        MoE families only: ``lm_verify`` refuses the VLM's cross blocks and
        a sliding window."""
        f = self.cfg.family
        if f not in _ATTENTION:
            raise ValueError(f"speculative verify needs an attention family with per-lane "
                             f"KV isolation, not {f!r}")
        return transformer.lm_verify(params, self.cfg, cache, batch["tokens"], batch["start"],
                                     batch["wlen"], batch["spec"], tiers=batch.get("tiers"),
                                     demand=batch.get("demand"))

    def cache_insert_slot(self, live, one, slot: int):
        """Write a single-slot prefilled cache into lane ``slot`` of a live
        cache (continuous-batching admission); attention families only."""
        if not self.fused_prefill:
            raise ValueError(
                f"single-slot cache admission needs an attention family with per-lane KV "
                f"isolation; family {self.cfg.family!r} (cross_every={self.cfg.cross_every}) "
                f"is served via the static batch path")
        return transformer.lm_cache_insert_slot(live, one, slot)

    def serve_params(self, wire_tree, packed: bool = True, drop_map=None,
                     tier_drop_map=None, device="cuda"):
        """Wire artifact -> serving param tree on ``device``: packed matmul
        weights and the rest decoded once (``packed``), or the whole tree
        decoded at load (``packed=False``).  ``drop_map`` realizes a tier by
        plane truncation; ``tier_drop_map`` stamps per-tier drop vectors on
        the packed leaves instead.  Returns (params, n_packed)."""
        from repro_torch.models.base import resolve_device
        from repro_torch.quant.store import dense_tree, serve_tree, tree_from_wire, truncate_tree

        store = tree_from_wire(wire_tree, resolve_device(device))
        descs = self.param_descs()
        if packed:
            return serve_tree(store, descs, drop_map=drop_map, tier_drop_map=tier_drop_map)
        if tier_drop_map:
            raise ValueError("per-request tier vectors need packed serving (the masks "
                             "apply inside the kernels)")
        if drop_map:
            store = truncate_tree(store, drop_map)
        # qsqlint: disable=QSQ001 -- the explicit packed=False opt-out:
        # caller asked for full dense decode at load time, once
        return dense_tree(store, like=descs), 0

    def input_descs(self, shape: ShapeConfig) -> dict:
        """The batch of a step at ``shape`` as descriptors: tokens (and labels
        when training), one new token a slot when decoding (the context
        lives in the cache); ``vision_embeds`` for the VLM and ``frames``
        for the encoder-decoder on train and prefill shapes."""
        cfg = self.cfg
        b = shape.global_batch

        def tok(s):
            return ParamDesc((b, s), ("batch", None), dtype=torch.int32, init="zeros")

        if shape.kind == "train":
            batch = {"tokens": tok(shape.seq_len), "labels": tok(shape.seq_len)}
        elif shape.kind == "prefill":
            batch = {"tokens": tok(shape.seq_len)}
        else:
            batch = {"tokens": tok(1)}
        if shape.kind in ("train", "prefill"):
            if cfg.family == "vlm":
                batch["vision_embeds"] = ParamDesc((b, cfg.vision_tokens, cfg.d_model),
                                                   ("batch", None, None), dtype=cfg.dtype,
                                                   init="normal")
            if cfg.family == "encdec":
                batch["frames"] = ParamDesc((b, cfg.enc_seq, cfg.d_model),
                                            ("batch", None, None), dtype=cfg.dtype,
                                            init="normal")
        return batch
