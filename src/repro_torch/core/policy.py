"""Per-layer quantization policy (the port of ``repro/core/policy.py``).

:class:`QuantPolicy` maps a tree path to a QSQConfig; the calibration
search :func:`sensitivity_rank` ranks layers by the loss increase their
quantization causes, and :func:`budgeted_policy` folds such a ranking into
per-layer phi overrides (``compress(sensitivity=...)`` does both).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core.qsq import QSQConfig
from repro_torch.tree import path_str, tree_leaves_with_path, tree_map_with_path

# Param-path regexes that are never quantized (tiny and sensitive), matched
# case-sensitively against the '/'-joined tree path.
DEFAULT_EXCLUDE = (
    "norm", "scale", "bias", "ln_", "_ln", "ln[0-9]",
    "a_log", "dt_bias", r"(^|/)D($|/)",
)

__all__ = ["DEFAULT_EXCLUDE", "QuantPolicy", "budgeted_policy", "path_str",
           "sensitivity_rank"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Decides, per parameter, whether and how to quantize."""

    base: QSQConfig = QSQConfig()
    min_numel: int = 1024
    min_ndim: int = 2
    exclude_res: tuple = DEFAULT_EXCLUDE
    overrides: Mapping[str, QSQConfig] = dataclasses.field(default_factory=dict)
    quantize_embeddings: bool = True

    def config_for(self, path: str, shape: tuple) -> QSQConfig | None:
        """QSQConfig for this param, or None to keep it full precision."""
        shape = tuple(shape)
        numel = int(np.prod(shape)) if shape else 1
        if len(shape) < self.min_ndim or numel < self.min_numel:
            return None
        for pat in self.exclude_res:
            if re.search(pat, path):
                return None
        if not self.quantize_embeddings and "embed" in path.lower():
            return None
        for pat, cfg in self.overrides.items():
            if re.search(pat, path):
                return cfg
        g = self.base.group_size
        while shape[0] % g != 0:
            g //= 2
            if g == 0:
                return None
        if g != self.base.group_size:
            return dataclasses.replace(self.base, group_size=g)
        return self.base


def sensitivity_rank(params, loss_fn: Callable, policy: QuantPolicy,
                     batch) -> list[tuple[str, float]]:
    """Rank quantizable layers by quantization-induced loss increase.

    Quantizes ONE layer at a time with its ``policy`` config (grouped along
    the leading axis, as the JAX package's ``quantize`` does), measures
    ``loss_fn(params, batch)`` (a scalar tensor) on the calibration batch,
    and sorts the deltas descending: most sensitive first.
    """
    from repro_torch.core import qsq as _qsq

    flat = tree_leaves_with_path(params)
    with torch.no_grad():
        base_loss = float(loss_fn(params, batch))
        results = []
        for path, leaf in flat:
            p = path_str(path)
            cfg = policy.config_for(p, tuple(leaf.shape))
            if cfg is None:
                continue
            deq = _qsq.dequantize(_qsq.quantize(leaf, cfg), leaf.dtype)
            mutated = tree_map_with_path(
                lambda q, a, p=p, deq=deq: deq if path_str(q) == p else a, params)
            results.append((p, float(loss_fn(mutated, batch)) - base_loss))
    return sorted(results, key=lambda t: -t[1])


def budgeted_policy(sens: list[tuple[str, float]], policy: QuantPolicy,
                    phi_by_rank=(4, 4, 2, 1)) -> QuantPolicy:
    """Assign higher phi (more levels) to more sensitive layers.

    ``phi_by_rank`` gives phi for sensitivity quartiles, most -> least
    sensitive.  Returns a policy with per-layer overrides.
    """
    if not sens:
        return policy
    n = len(sens)
    overrides = dict(policy.overrides)
    for rank, (path, _) in enumerate(sens):
        quartile = min(len(phi_by_rank) - 1, (rank * len(phi_by_rank)) // n)
        overrides[re.escape(path)] = dataclasses.replace(policy.base,
                                                         phi=phi_by_rank[quartile])
    return dataclasses.replace(policy, overrides=overrides)
