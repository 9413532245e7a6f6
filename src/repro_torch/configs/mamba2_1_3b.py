"""mamba2-1.3b — attention-free SSD (state-space duality) LM.

[arXiv:2405.21060; unverified].  48L d_model=2048, vocab=50280,
ssm_state=128, head_dim 64, d_inner = 2*d_model.
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    source="arXiv:2405.21060",
)

# Reduced same-family config for CPU smoke tests (one fwd/train step).
SMOKE_CONFIG = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv=1,
    d_ff=0,
    vocab=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_groups=1,
    ssm_chunk=16,
    dtype=torch.float32,
    remat=False,
)
