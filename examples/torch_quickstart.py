"""Quickstart on the PyTorch port: the paper's whole methodology in one script.

Trains LeNet on the synthetic image task, applies Quality Scalable
Quantization at phi = 1/2/4, reports accuracy against quality level
(Fig. 7), model-size savings (Eq. 11/12 / Fig. 9) and the +zeros effect,
then shows the CSD quality-scalable-multiplier rounding (Fig. 11).

  PYTHONPATH=src python examples/torch_quickstart.py                # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.csd import csd_round, partial_product_savings
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsq import QSQConfig, zeros_fraction
from repro_torch.models.cnn import LENET, cnn_accuracy
from repro_torch.quant import dequantize_pytree, is_store, pytree_bits_report, quantize_pytree
from repro_torch.train.cnn import train_cnn
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("1) training LeNet (synthetic MNIST-shaped task)...")
    params, tr_i, tr_l, ev_i, ev_l = train_cnn(LENET, steps=150, device=args.device)
    acc = cnn_accuracy(params, LENET, ev_i, ev_l)
    print(f"   float accuracy: {acc:.4f}")

    print("2) Quality Scalable Quantization at three quality levels:")
    for phi in (1, 2, 4):
        policy = QuantPolicy(base=QSQConfig(phi=phi, group_size=16), min_numel=256)
        qp = quantize_pytree(params, policy)
        acc_q = cnn_accuracy(dequantize_pytree(qp, like=params), LENET, ev_i, ev_l)
        rep = pytree_bits_report(params, qp)
        print(f"   phi={phi}: accuracy={acc_q:.4f} (drop {acc - acc_q:+.4f})  "
              f"model-size savings={rep['memory_savings'] * 100:.2f}%")

    print("3) zeros introduced by quantization (paper: +6%):")
    qp = quantize_pytree(params, QuantPolicy(base=QSQConfig(phi=4, group_size=16),
                                             min_numel=256))
    qleaves = [q for q in tree_leaves(qp.tree, is_leaf=is_store) if is_store(q)]
    z_fp = sum(float(zeros_fraction(a)) for a in tree_leaves(params) if a.dim() >= 2)
    z_fp /= sum(a.dim() >= 2 for a in tree_leaves(params))
    z_q = sum(float(zeros_fraction(q.levels)) for q in qleaves) / len(qleaves)
    print(f"   zeros: {z_fp * 100:.2f}% -> {z_q * 100:.2f}%")

    print("4) CSD quality-scalable multiplier (weight-rounding view):")
    w = tree_leaves(params)[0]
    for k in (1, 2, 3):
        err = float(((w - csd_round(w, k)) ** 2).mean())
        s = float(partial_product_savings(w, k))
        print(f"   k={k} digits: mse={err:.2e}, partial products skipped={s * 100:.1f}%")
    print("done.")


if __name__ == "__main__":
    main()
