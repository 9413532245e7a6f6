"""Uniform model API (the port of ``repro/models/api.py``), dense family.

Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1, item 8 (MoE family)",
    "vlm": "ROADMAP Queue 1, item 10 (the other families)",
    "ssm": "ROADMAP Queue 1, item 10 (the other families)",
    "hybrid": "ROADMAP Queue 1, item 10 (the other families)",
    "encdec": "ROADMAP Queue 1, item 10 (the other families)",
    "cnn": "ROADMAP Queue 1, item 9 (the paper's own models)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        f = self.cfg.family
        if f != "dense":
            raise NotImplementedError(
                f"family {f!r} is not ported yet: {_NOT_PORTED.get(f, 'ROADMAP Queue 1')}")

    def param_descs(self):
        return transformer.lm_descs(self.cfg)

    def loss(self, params, batch):
        """Scalar next-token loss; batch = {tokens (B, S), labels (B, S)}."""
        return transformer.lm_loss(params, self.cfg, batch)

    def forward(self, params, batch):
        """Logits (B, S, vocab) f32 for batch = {tokens (B, S)}."""
        return transformer.lm_forward(params, self.cfg, batch["tokens"])

    def cache_descs(self, batch: int, cache_len: int):
        return transformer.lm_cache_descs(self.cfg, batch, cache_len)

    def decode(self, params, cache, batch):
        """One decode step; batch = {tokens (B,1), [active, tiers, demand]}."""
        return transformer.lm_decode(params, self.cfg, cache, batch["tokens"],
                                     active=batch.get("active"),
                                     tiers=batch.get("tiers"),
                                     demand=batch.get("demand"))

    def prefill(self, params, cache, tokens, lengths=None, tiers=None, demand=None):
        """Prime a decode cache for whole (B, S) left-padded prompts ->
        (cache, last_logits)."""
        from repro_torch.train.step import make_cache_prefill_step

        if lengths is None:
            lengths = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        return make_cache_prefill_step(self)(params, cache, tokens, lengths, tiers, demand)

    def verify(self, params, cache, batch):
        """Batched multi-position forward for self-speculative verify: each
        lane's window ``[start, start + wlen)`` scored in one pass at the
        lane's verify tier -> (logits (B, W, V) f32, cache)."""
        return transformer.lm_verify(params, self.cfg, cache, batch["tokens"], batch["start"],
                                     batch["wlen"], batch["spec"], tiers=batch.get("tiers"),
                                     demand=batch.get("demand"))

    def cache_insert_slot(self, live, one, slot: int):
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
        return dense_tree(store, like=descs), 0
