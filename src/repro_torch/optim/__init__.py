"""Optimizer, LR schedule and QSQ gradient compression of the port."""
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init_descs, adamw_update
from repro_torch.optim.compression import (
    GradCompressionConfig,
    compress_grads,
    compression_state_descs,
)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "OptState", "adamw_init_descs", "adamw_update",
    "cosine_schedule", "GradCompressionConfig", "compression_state_descs",
    "compress_grads",
]
