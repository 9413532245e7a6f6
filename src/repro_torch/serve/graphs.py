"""The serving steps as CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX engine traces each continuous-batching program once per static
argument (``demand``; the verify once per (demand, window width)) and
replays the compiled program for every later call.  :class:`StepGraphs`
does the same with ``torch.cuda.CUDAGraph``: the first call of a key
warms the step up on a side stream, captures it into a graph, and every
call of that key replays it.  A step's tensor inputs are the engine's
static buffers (tokens, active mask, tiers, the admission's and the
verify's inputs), so a tier flip, an admission, an eviction or a cancel is
a copy into those buffers and never a new capture.  All graphs share the
memory pool they are given (an engine gives all of its sessions one); a
graph's outputs stay valid until its next replay.

The Python counters of the dispatcher and the kernel wrappers
(``dispatch.counters``, ``dispatch.traffic``, ``kernels.qsq.launches``) do
not run on a replay: each graph records what its capture would have
counted (``dispatch.record_counts``) and adds it on every replay
(``dispatch.add_counts``), so they stay per call.

Elsewhere (a CPU device, or ``eager=True``: the counterpart of
``jax.disable_jit``) the step runs directly on the same buffers at every
call; the keys are recorded all the same, so :func:`no_recapture
<repro_torch.analysis.retrace.no_recapture>` watches both.
"""
from __future__ import annotations

from typing import Callable, Hashable

import torch

from repro_torch.kernels import dispatch


class _Graph:
    __slots__ = ("graph", "out", "counts")

    def __init__(self, graph, out, counts):
        self.graph = graph
        self.out = out
        self.counts = counts


class StepGraphs:
    """Serving steps keyed by their static arguments; see the module doc.

    ``run(key, fn, restore)`` calls ``fn()`` (a closure over the static
    buffers; its result is a tensor or a tuple of tensors).  ``restore``
    lists the state tensors that ``fn`` changes in a way a second run
    would not repeat (the KV ``pos`` a decode advances): the warm-up's
    changes to them are undone before the capture."""

    def __init__(self, device: torch.device, eager: bool = False, pool=None):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda" and not eager
        self.graphs: dict[Hashable, _Graph | None] = {}
        self.pool = None
        if self.capture:
            from repro_torch.kernels import build

            build.load()  # the kernels' library exists before any capture
            self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()

    def __len__(self) -> int:
        return len(self.graphs)

    def keys(self):
        return list(self.graphs)

    def run(self, key: Hashable, fn: Callable, restore: tuple[torch.Tensor, ...] = ()):
        if not self.capture:
            self.graphs.setdefault(key, None)
            return fn()
        rec = self.graphs.get(key)
        if rec is None:
            rec = self.graphs[key] = self._capture(fn, restore)
        rec.graph.replay()
        dispatch.add_counts(rec.counts)
        return rec.out

    def _capture(self, fn: Callable, restore: tuple[torch.Tensor, ...]) -> _Graph:
        """Warm ``fn`` up on a side stream (its one-time set-up: cuBLAS
        workspaces, per-kernel attributes, cached tensors), undo its changes
        to ``restore``, then capture it.  Counts nothing; a failed capture
        raises."""
        saved = [t.clone() for t in restore]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), dispatch.record_counts():
            fn()
        main.wait_stream(side)
        for t, s in zip(restore, saved, strict=True):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with dispatch.record_counts() as counts:
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn()
        return _Graph(graph, out, counts)
