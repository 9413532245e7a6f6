"""Fault-tolerant checkpointing (the port of ``repro/checkpoint/manager.py``).

* **Atomic**: each checkpoint is written to a tmp file and renamed, so a
  crashed writer never corrupts the latest checkpoint.
* **Resumable**: ``latest_step()`` plus the data step in the meta file
  reproduce the exact training stream.
* **Shared format**: one npz per step keyed by ``jax.tree_util.keystr``
  paths (``.params['blocks']['attn']['wq']``, ``.opt.step``), so each
  package restores the other's checkpoints.  bfloat16 leaves are stored as
  their raw 2-byte words (numpy's ``V2``), as numpy writes JAX's bfloat16.
* **Async**: ``save`` copies the state to the host before it returns, then
  writes the file on a background thread.
* **QSQ wire export**: ``export_wire`` writes the params in the 3-bit +
  scalar artifact format that ``EdgeArtifact`` reads.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.models.base import is_desc, resolve_device
from repro_torch.quant.artifact import atomic_savez, load_wire_npz, save_wire_npz
from repro_torch.quant.store import quantize_tree, tree_to_wire
from repro_torch.tree import keystr, tree_leaves_with_path, tree_map, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep_last: int = 3
    every_steps: int = 100
    async_save: bool = True


def _host(leaf) -> np.ndarray:
    """A tensor leaf as a host numpy array that shares no memory with it."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):  # bfloat16 words
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_pytree(tree, path: str | Path) -> Path:
    """Atomic single-file save: one npz entry per leaf, keyed by its keystr."""
    return atomic_savez({keystr(p): _host(leaf) for p, leaf in tree_leaves_with_path(tree)},
                        Path(path))


def load_pytree(tree_like, path: str | Path, device=None):
    """Load into the structure of ``tree_like`` (descriptors or tensors).
    Each leaf lands on ``device``, or where its ``tree_like`` leaf lies
    (the CPU for a descriptor) when ``device`` is None."""
    dev = None if device is None else resolve_device(device)
    with np.load(Path(path), allow_pickle=False) as data:
        def leaf(p, like):
            where = dev or (like.device if isinstance(like, torch.Tensor) else "cpu")
            return _tensor(data[keystr(p)]).to(where)

        return tree_map_with_path(leaf, tree_like, is_leaf=is_desc)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- bookkeeping ------------------------------------------------------
    def step_path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.npz"

    def meta_path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.meta.json"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.npz")
                      if ".tmp" not in p.name)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore ---------------------------------------------------
    def _save_sync(self, state, step: int, extra: dict):
        save_pytree(state, self.step_path(step))
        mp = self.meta_path(step)
        tmp = mp.with_suffix(".tmp")
        tmp.write_text(json.dumps({"step": step, **extra}, indent=2))
        tmp.rename(mp)
        self._gc()

    def _save_async(self, state, step: int, extra: dict):
        try:
            self._save_sync(state, step, extra)
        except Exception as e:  # noqa: BLE001 -- re-raised by wait()
            self._error = e

    def save(self, state, step: int, extra: dict | None = None, wait: bool = False):
        """Checkpoint the train state (on a background thread unless
        ``wait`` or ``async_save=False``).  The host copy is taken before
        this returns, so the caller may reuse or mutate the state at once."""
        extra = extra or {}
        self.wait()  # one in-flight save at a time
        snapshot = tree_map(_host, state)
        if self.cfg.async_save and not wait:
            self._thread = threading.Thread(target=self._save_async,
                                            args=(snapshot, step, extra), daemon=True)
            self._thread.start()
        else:
            self._save_sync(snapshot, step, extra)

    def wait(self):
        """Join the in-flight save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the background checkpoint save failed") from err

    def restore(self, tree_like, step: int | None = None, device=None):
        """Returns (state, meta) or (None, None) when no checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        state = load_pytree(tree_like, self.step_path(step), device=device)
        return state, json.loads(self.meta_path(step).read_text())

    def _gc(self):
        for s in self.all_steps()[: -self.cfg.keep_last]:
            self.step_path(s).unlink(missing_ok=True)
            self.meta_path(s).unlink(missing_ok=True)

    # -- QSQ wire export / import (the EdgeArtifact npz format) ------------
    def export_wire(self, params, policy: QuantPolicy, name: str = "wire",
                    descs=None) -> Path:
        """Write the 3-bit + scalar encoded params; returns the file path.
        With the model's ``descs``, matmul weights group along their
        contraction axis (the layout the engines serve packed)."""
        return save_wire_npz(tree_to_wire(quantize_tree(params, policy, descs)),
                             self.dir / f"{name}.npz")

    def load_wire(self, name_or_path: str | Path = "wire"):
        """Inverse of :func:`export_wire`: npz -> nested wire tree (lossless)."""
        path = Path(name_or_path)
        if not path.suffix:
            path = path.with_suffix(".npz")
        if len(path.parts) == 1:  # bare name -> this manager's directory
            path = self.dir / path
        return load_wire_npz(path)[0]
