"""Synthetic data streams of the port."""
from repro_torch.data.pipeline import DataIteratorState, LMDataConfig, lm_batch, lm_batch_iterator

__all__ = ["DataIteratorState", "LMDataConfig", "lm_batch", "lm_batch_iterator"]
