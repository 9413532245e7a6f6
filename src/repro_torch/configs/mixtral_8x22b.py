"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf].  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA window 4096.
"""
import torch

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    moe=MoEConfig(n_experts=8, top_k=2),
    window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088; hf",
)

# Reduced same-family config for CPU smoke tests; its window of 32 wraps
# within a short stream.
SMOKE_CONFIG = ArchConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2),
    window=32,
    dtype=torch.float32,
    remat=False,
)
