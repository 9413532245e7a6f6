"""llama-3.2-vision-11b — decoder with gated cross-attn blocks every 5 layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256.  Vision tower is a STUB: the caller
supplies precomputed patch embeddings (B, 1024, 4096).
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=128256,
    cross_every=5,
    vision_tokens=1024,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

# Reduced same-family config for CPU smoke tests (one fwd/train step).
SMOKE_CONFIG = ArchConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    cross_every=2,
    vision_tokens=16,
    dtype=torch.float32,
    remat=False,
)
