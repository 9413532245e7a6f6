"""Deterministic synthetic data (the port of ``repro/data/pipeline.py``):
an LM token stream and the class-template image task of the paper's CNNs.

A fixed random bigram transition table (each token has ``branching``
likely successors) makes a token stream with learnable structure.  The
table comes from numpy's ``RandomState(seed)``, exactly as in the JAX
package.  The per-step draws (start tokens and successor choices) come
from numpy too, keyed by ``seed * 1_000_003 + step``, so every device sees
the same tokens; they are not the JAX package's ``jax.random`` draws.  A
batch is a pure function of (config, step), so resuming at a step replays
the stream exactly.  The image functions are numpy in both packages, so
their images, labels and batches equal the JAX package's bit for bit.
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


def synthetic_image_dataset(n: int, hw: tuple, channels: int, n_classes: int,
                            seed: int = 0, noise: float = 0.35
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Class-template images + noise: (images (N,H,W,C) f32 in [0,1], labels)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    templates = rng.rand(n_classes, h, w, channels).astype(np.float32)
    # smooth the templates a little so convs have local structure to find
    for _ in range(2):
        templates = 0.25 * (
            np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
            + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)
        )
    labels = rng.randint(0, n_classes, size=n).astype(np.int32)
    images = templates[labels] + noise * rng.randn(n, h, w, channels).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels


def image_batches(images, labels, batch: int, seed: int = 0, start_step: int = 0,
                  device="cpu") -> Iterator[tuple[int, dict]]:
    """Infinite shuffled batch iterator with reproducible order: yields
    (step, {images (B,H,W,C) f32, labels (B,) int32}) on ``device``."""
    dev = resolve_device(device)
    n = images.shape[0]
    step = start_step
    while True:
        rng = np.random.RandomState(seed + step)
        idx = rng.randint(0, n, size=batch)
        yield step, {"images": torch.from_numpy(np.ascontiguousarray(images[idx])).to(dev),
                     "labels": torch.from_numpy(np.ascontiguousarray(labels[idx])).to(dev)}
        step += 1
