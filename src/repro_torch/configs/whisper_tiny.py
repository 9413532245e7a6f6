"""whisper-tiny — encoder-decoder; conv/mel frontend is a STUB.

[arXiv:2212.04356; unverified].  4+4L d_model=384 6H d_ff=1536 vocab=51865.
The caller supplies precomputed frame embeddings (B, 1500, 384).
"""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    source="arXiv:2212.04356",
)

# Reduced same-family config for CPU smoke tests (one fwd/train step).
SMOKE_CONFIG = ArchConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    enc_layers=2,
    enc_seq=32,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    dtype=torch.float32,
    remat=False,
)
