"""TrainState (the port of ``repro/train/state.py``): params + AdamW
moments + grad-compression error feedback."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.optim import (
    GradCompressionConfig,
    OptState,
    adamw_init_descs,
    compression_state_descs,
)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    err: Any  # error-feedback residuals (() placeholders when disabled)


def train_state_descs(model, cc: GradCompressionConfig | None = None) -> TrainState:
    cc = cc or GradCompressionConfig()
    pd = model.param_descs()
    return TrainState(params=pd, opt=adamw_init_descs(pd), err=compression_state_descs(pd, cc))
