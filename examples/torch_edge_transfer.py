"""The paper's headline scenario on the PyTorch port, end to end:

  cloud:  train LeNet -> compress to an EdgeArtifact (3-bit codes +
          scalars) -> write it to the "channel" (a file standing in for
          the network link)
  edge:   load the artifact -> decode with shift/scale only -> run
          inference, at more than one quality tier from the SAME payload

Reports the channel payload size (Eq. 11/12), the decode time and the
accuracy change, then turns the quality dial: the 'lo' tier drops LSB code
planes from the least-sensitive layers without a second transmission or
any re-quantization.  The artifact is the JAX package's format.

  PYTHONPATH=src python examples/torch_edge_transfer.py                # on the GPU
  PYTHONPATH=src python examples/torch_edge_transfer.py --device cpu
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch import api
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsq import QSQConfig
from repro_torch.models.cnn import LENET, cnn_accuracy
from repro_torch.train.cnn import train_cnn
from repro_torch.tree import tree_leaves


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    print("== CLOUD ==")
    params, tr_i, tr_l, ev_i, ev_l = train_cnn(LENET, steps=300, n=1024, device=dev)
    acc_fp = cnn_accuracy(params, LENET, ev_i, ev_l)
    print(f"trained LeNet: accuracy {acc_fp:.4f}")
    policy = QuantPolicy(base=QSQConfig(phi=4, group_size=16, refit_alpha=True), min_numel=256)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        # model-free compress: no serving Model, but the artifact still
        # carries the tier spec and the sensitivity ranking for dense decode
        artifact = api.compress(None, params, policy=policy, device=dev)
        wire_path = artifact.save(Path(d) / "lenet.edge.npz")
        t_enc = time.perf_counter() - t0
        raw_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
        wire_bytes = wire_path.stat().st_size
        print(f"encoded in {t_enc * 1e3:.0f} ms -> channel payload {wire_bytes / 1e3:.1f} kB "
              f"(raw {raw_bytes / 1e3:.1f} kB, {(1 - wire_bytes / raw_bytes) * 100:.1f}% saved)")

        print("== EDGE ==")
        received = api.load(wire_path)
        t0 = time.perf_counter()
        decoded = received.dense_params(quality="hi", like=params, device=dev)
        _sync(dev)
        t_dec = time.perf_counter() - t0
        acc_q = cnn_accuracy(decoded, LENET, ev_i, ev_l)
        print(f"decoded in {t_dec * 1e3:.0f} ms (shift/scale only) -> accuracy {acc_q:.4f} "
              f"(drop {acc_fp - acc_q:+.4f})")
        print("paper comparison: 82.49% size reduction, ~1.1 point drop")
        for tier in ("mid", "lo"):
            acc_t = cnn_accuracy(received.dense_params(quality=tier, like=params, device=dev),
                                 LENET, ev_i, ev_l)
            print(f"tier {tier!r}: {len(received.drop_map(tier))} layers LSB-truncated -> "
                  f"accuracy {acc_t:.4f} (drop {acc_fp - acc_t:+.4f}, no re-transmission)")


if __name__ == "__main__":
    main()
