"""smollm-135m — small llama-arch dense decoder.

[hf:HuggingFaceTB/SmolLM-135M; hf].  30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152, bf16.
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv=3,
    d_ff=1536,
    vocab=49152,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)

# Reduced same-family config for CPU smoke tests.
SMOKE_CONFIG = ArchConfig(
    name="smollm-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv=1,
    d_ff=96,
    vocab=256,
    dtype=torch.float32,
    remat=False,
)
