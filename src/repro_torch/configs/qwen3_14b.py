"""qwen3-14b — dense decoder with qk_norm.

[hf:Qwen/Qwen3-14B; hf].  40L d_model=5120 40H (GQA kv=8) head_dim=128
d_ff=17408 vocab=151936, rope_theta=1e6, bf16.
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-14B; hf",
)

# Reduced same-family config for CPU smoke tests.
SMOKE_CONFIG = ArchConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qk_norm=True,
    dtype=torch.float32,
    remat=False,
)
