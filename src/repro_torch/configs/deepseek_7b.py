"""deepseek-7b — llama-arch dense decoder (MHA: kv == heads).

[arXiv:2401.02954; hf].  30L d_model=4096 32H (kv=32) d_ff=11008
vocab=102400, bf16.
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=11008,
    vocab=102400,
    source="arXiv:2401.02954; hf",
)

# Reduced same-family config for CPU smoke tests.
SMOKE_CONFIG = ArchConfig(
    name="deepseek-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    dtype=torch.float32,
    remat=False,
)
