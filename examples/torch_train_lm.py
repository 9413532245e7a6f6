"""Training example on the PyTorch port: LM training with checkpoint/restart,
QSQ gradient compression, the straggler watchdog, and a QSQ wire export at
the end.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300              # on the GPU
  PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu

The default trains the smoke config of ``--arch`` (the same family and code
path as the published one); ``--full`` trains the published widths, and
``--mid`` a ~20M-parameter variant of smollm-135m.  Checkpoints go to ``--ckpt``,
or to a temporary directory that is removed at the end.
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import CheckpointConfig
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsq import QSQConfig
from repro_torch.data.pipeline import LMDataConfig, lm_batch
from repro_torch.models.api import Model
from repro_torch.optim import AdamWConfig, GradCompressionConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mid", action="store_true",
                    help="~20M param variant of smollm_135m (that --arch only)")
    ap.add_argument("--full", action="store_true", help="the published widths")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (default: temporary)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mid and args.arch != "smollm_135m":
        ap.error("--mid is a variant of smollm_135m")

    cfg = get_arch(args.arch, smoke=not args.full)
    if args.mid:
        cfg = dataclasses.replace(cfg, n_layers=6, d_model=256, n_heads=8, n_kv=4,
                                  d_ff=1024, vocab=4096)
    model = Model(cfg)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(
            total_steps=args.steps,
            log_every=max(args.steps // 20, 1),
            opt=AdamWConfig(lr=3e-3),
            compression=GradCompressionConfig(enabled=True, min_numel=4096),
            checkpoint=CheckpointConfig(directory=args.ckpt or tmp, every_steps=100),
        )
        trainer = Trainer(model, tcfg, lambda s: lm_batch(data, s), device=args.device)
        state, start = trainer.init_state()
        if start:
            print(f"resumed from checkpoint at step {start}")
        state, last = trainer.run(state, start)

        for m in trainer.metrics_log:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"{m['sec_per_step'] * 1e3:.0f} ms")
        if trainer.straggler_events:
            print(f"straggler events: {trainer.straggler_events}")

        # export the paper's wire artifact
        wire_path = trainer.ckpt.export_wire(
            state.params, QuantPolicy(base=QSQConfig(group_size=16), min_numel=512))
        full = sum(a.numel() * a.element_size() for a in tree_leaves(state.params))
        print(f"wire export: {wire_path.name} ({wire_path.stat().st_size / 1e6:.2f} MB vs "
              f"{full / 1e6:.2f} MB raw); done at step {last} on {trainer.device}")
        trainer.ckpt.wait()  # an async save must finish before the directory goes
    return trainer


if __name__ == "__main__":
    main()
