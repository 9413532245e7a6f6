"""Training launcher of the port.

    python -m repro_torch.launch.train --arch smollm_135m --full --grad-compression

trains the published widths on the card (``--device cuda``, the default;
it raises without CUDA).  Without ``--full`` it trains the reduced smoke
config; ``--device cpu`` runs the plain PyTorch path.  The stream is the
synthetic bigram LM stream (``data/pipeline.py``).
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import CheckpointConfig
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.pipeline import LMDataConfig, lm_batch
from repro_torch.models.api import Model
from repro_torch.optim import AdamWConfig, GradCompressionConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_135m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    model = Model(cfg)
    data_cfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        log_every=max(args.steps // 10, 1),
        opt=AdamWConfig(lr=1e-3),
        compression=GradCompressionConfig(enabled=args.grad_compression),
        checkpoint=CheckpointConfig(directory=args.ckpt) if args.ckpt else None,
    )
    trainer = Trainer(model, tcfg, lambda step: lm_batch(data_cfg, step), device=args.device)
    _, last = trainer.run()
    for m in trainer.metrics_log:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  {m['sec_per_step'] * 1e3:.0f} ms")
    print(f"done at step {last}; device={trainer.device}")
    return trainer


if __name__ == "__main__":
    main()
