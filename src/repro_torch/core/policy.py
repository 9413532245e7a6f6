"""Per-layer quantization policy (the port of ``repro/core/policy.py``).

``sensitivity_rank`` and ``budgeted_policy`` are not ported yet (ROADMAP
Queue 1, item 7).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import numpy as np

from repro_torch.core.qsq import QSQConfig
from repro_torch.tree import path_str

# Param-path regexes that are never quantized (tiny and sensitive), matched
# case-sensitively against the '/'-joined tree path.
DEFAULT_EXCLUDE = (
    "norm", "scale", "bias", "ln_", "_ln", "ln[0-9]",
    "a_log", "dt_bias", r"(^|/)D($|/)",
)

__all__ = ["DEFAULT_EXCLUDE", "QuantPolicy", "path_str"]


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
