"""phi4-mini-3.8b — dense decoder, RoPE+SwiGLU+GQA, 200k vocab.

[arXiv:2412.08905; hf].  32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, bf16.
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    d_ff=8192,
    vocab=200064,
    source="arXiv:2412.08905; hf",
)

# Reduced same-family config for CPU smoke tests.
SMOKE_CONFIG = ArchConfig(
    name="phi4-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=512,
    dtype=torch.float32,
    remat=False,
)
