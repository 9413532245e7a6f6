"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf].  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 every other layer; 9 blocks of 8 layers,
1 attention + 7 mamba per block.  SSD mixer: d_inner 16384, 128 heads
of dim 128, 8 groups, state 128.
"""
import torch

from repro_torch.configs.base import ArchConfig, HybridConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2),
    hybrid=HybridConfig(period=8, moe_every=2),
    ssm_state=128,
    ssm_head_dim=128,
    ssm_groups=8,
    source="arXiv:2403.19887; hf",
)

# Reduced same-family config for CPU smoke tests (one fwd/train step).
SMOKE_CONFIG = ArchConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2),
    hybrid=HybridConfig(period=8, moe_every=2),
    ssm_state=16,
    ssm_head_dim=32,
    ssm_groups=2,
    ssm_chunk=16,
    dtype=torch.float32,
    remat=False,
)
