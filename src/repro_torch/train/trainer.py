"""Fault-tolerant training loop (the port of ``repro/train/trainer.py``).

* checkpoint/restart: checkpoints every K steps, resume from the latest
  one including the data step, so a killed run continues exactly;
* preemption: SIGTERM (or :meth:`Trainer.request_preemption`) writes a
  final checkpoint before the loop returns;
* straggler watchdog: a step slower than ``straggler_factor`` x the running
  median is logged in ``straggler_events``;
* grad compression: QSQ on gradients with error feedback
  (``optim/compression.py``; the K5 kernel on a card).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.models.base import init_params, resolve_device
from repro_torch.optim import AdamWConfig, GradCompressionConfig
from repro_torch.train.state import TrainState, train_state_descs
from repro_torch.train.step import make_train_step


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0  # step > factor * running median => event
    opt: AdamWConfig = AdamWConfig()
    compression: GradCompressionConfig = GradCompressionConfig()
    checkpoint: CheckpointConfig | None = None


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, batch_fn: Callable[[int], dict],
                 device="cuda"):
        """batch_fn(step) -> {tokens, labels} (tensors or arrays; a pure
        function of the step, so the stream resumes).  Training runs on
        ``device``; a CUDA device without CUDA raises here."""
        self.model = model
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, cfg.opt, cfg.compression, cfg.total_steps)
        self.ckpt = CheckpointManager(cfg.checkpoint) if cfg.checkpoint else None
        self.straggler_events: list[dict] = []
        self.metrics_log: list[dict] = []
        self._preempted = False

    # -- state ------------------------------------------------------------
    def init_state(self) -> tuple[TrainState, int]:
        """A fresh state from ``cfg.seed``, or the latest checkpoint's."""
        descs = train_state_descs(self.model, self.cfg.compression)
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        state = init_params(descs, gen, device=self.device)
        start = 0
        if self.ckpt is not None:
            restored, meta = self.ckpt.restore(state)
            if restored is not None:
                state, start = restored, int(meta["step"])
        return state, start

    # -- preemption ---------------------------------------------------------
    def _install_preemption_handler(self):
        def handler(signum, frame):  # noqa: ARG001
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def request_preemption(self):
        """Programmatic preemption trigger (used by tests)."""
        self._preempted = True

    def _batch(self, step: int) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in self.batch_fn(step).items()}

    # -- loop ---------------------------------------------------------------
    def run(self, state: TrainState | None = None, start_step: int | None = None,
            step_hook: Callable | None = None):
        """Train until total_steps or preemption.  Returns (state, last_step)."""
        if state is None or start_step is None:
            state, start_step = self.init_state()
        self._install_preemption_handler()

        durations: list[float] = []
        for step in range(start_step, self.cfg.total_steps):
            t0 = time.time()
            state, metrics = self.step_fn(state, self._batch(step))
            loss = float(metrics["loss"])  # waits for the step, so wall time is real
            if step_hook is not None:
                step_hook(step, state, metrics)
            dt = time.time() - t0  # includes the hook, so tests can inject delays

            if len(durations) >= 5:
                med = float(np.median(durations[-50:]))
                if dt > self.cfg.straggler_factor * med:
                    self.straggler_events.append({"step": step, "duration": dt, "median": med})
            durations.append(dt)

            if step % self.cfg.log_every == 0:
                self.metrics_log.append({"step": step, "loss": loss, "sec_per_step": dt})

            next_step = step + 1
            if self.ckpt and next_step % self.ckpt.cfg.every_steps == 0:
                self.ckpt.save(state, next_step, extra={"data_state": {"step": next_step}})
            if self._preempted:
                if self.ckpt:
                    self.ckpt.save(state, next_step, extra={"data_state": {"step": next_step},
                                                            "preempted": True}, wait=True)
                return state, next_step

        if self.ckpt:
            self.ckpt.save(state, self.cfg.total_steps,
                           extra={"data_state": {"step": self.cfg.total_steps}}, wait=True)
            self.ckpt.wait()
        return state, self.cfg.total_steps
