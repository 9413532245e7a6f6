"""Deterministic synthetic LM stream (the port of the LM half of
``repro/data/pipeline.py``).

A fixed random bigram transition table (each token has ``branching``
likely successors) makes a token stream with learnable structure.  The
table comes from numpy's ``RandomState(seed)``, exactly as in the JAX
package.  The per-step draws (start tokens and successor choices) come
from numpy too, keyed by ``seed * 1_000_003 + step``, so every device sees
the same tokens; they are not the JAX package's ``jax.random`` draws.  A
batch is a pure function of (config, step), so resuming at a step replays
the stream exactly.  The image half waits for the CNN slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.models.base import resolve_device


class DataIteratorState(NamedTuple):
    step: int
    seed: int


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8  # out-degree of the bigram graph (peakedness)


def _bigram_table(vocab: int, branching: int, seed: int) -> np.ndarray:
    """Each token has ``branching`` likely successors (deterministic)."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(vocab, branching)).astype(np.int32)


def lm_batch(cfg: LMDataConfig, step: int, device="cpu") -> dict:
    """{tokens (B, S), labels (B, S)} int32 on ``device`` for one step;
    labels are the tokens shifted left by one (wrapping)."""
    table = _bigram_table(cfg.vocab, cfg.branching, cfg.seed)
    rng = np.random.RandomState(cfg.seed * 1_000_003 + step)
    b, s = cfg.global_batch, cfg.seq_len
    tok = rng.randint(0, cfg.vocab, size=b).astype(np.int32)
    choices = rng.randint(0, cfg.branching, size=(b, s))
    seq = np.empty((b, s), np.int32)
    for t in range(s):  # seq[:, t] is the walk's token before its t-th move
        seq[:, t] = tok
        tok = table[tok, choices[:, t]]
    labels = np.concatenate([seq[:, 1:], seq[:, :1]], axis=1)
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(seq).to(dev), "labels": torch.from_numpy(labels).to(dev)}


def lm_batch_iterator(cfg: LMDataConfig, state: DataIteratorState | None = None,
                      device="cpu") -> Iterator[tuple[DataIteratorState, dict]]:
    """Yields (state_after, batch); resuming from a saved state replays the
    identical stream."""
    step = state.step if state else 0
    while True:
        batch = lm_batch(cfg, step, device)
        step += 1
        yield DataIteratorState(step=step, seed=cfg.seed), batch
