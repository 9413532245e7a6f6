"""qwen3-moe-30b-a3b — 128-expert top-8 fine-grained MoE with qk_norm.

[hf:Qwen/Qwen3-30B-A3B; hf].  48L d_model=2048 32H (GQA kv=4, head_dim 128)
per-expert d_ff=768, vocab=151936, MoE 128e top-8, rope_theta=1e6, bf16.
"""
import torch

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

# Reduced same-family config for CPU smoke tests.
SMOKE_CONFIG = ArchConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=32,
    vocab=256,
    qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2),
    dtype=torch.float32,
    remat=False,
)
