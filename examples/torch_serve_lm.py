"""Serving example on the PyTorch port: the quality-dial facade, compress -> save -> serve.

  PYTHONPATH=src python examples/torch_serve_lm.py [--arch mixtral_8x22b]   # on the GPU
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The edge flow end to end through ``repro_torch.api``, at the smoke config of
``--arch``: the model is compressed once into a self-describing EdgeArtifact
(3-bit codes + scalars), saved, loaded back as the receiver would, and
served at every quality tier; lower tiers drop LSB bit-planes from the
least-sensitive layers without ever re-quantizing.  Weights are random,
drawn from a ``torch.Generator`` seeded 0.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch import api
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models.api import Model
from repro_torch.models.base import init_params, resolve_device
from repro_torch.quant import tree_bits_report
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek_7b")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = Model(get_arch(args.arch, smoke=True))
    params = init_params(model.param_descs(), torch.Generator(device=device).manual_seed(0),
                         device=device)
    # one call replaces quantize -> pack -> export: the artifact carries the
    # wire tree plus the tier spec and the per-layer sensitivity ranking
    artifact = api.compress(model, params, device=device)
    raw = sum(a.numel() * a.element_size() for a in tree_leaves(params))

    outs = {}
    with tempfile.TemporaryDirectory() as d:
        path = artifact.save(Path(d) / "model.edge.npz")
        print(f"channel payload: {path.stat().st_size / 1e6:.2f} MB (raw {raw / 1e6:.2f} MB)")

        # the edge side: load the self-describing artifact and dial quality
        received = api.load(path)
        prompts = [[1, 2, 3, 4], [10, 20], [7, 7, 7]]
        for tier in received.quality_names():
            eng = received.engine(quality=tier, batch_slots=4, device=device)
            rep = tree_bits_report(eng.params)
            t0 = time.perf_counter()
            outs[tier] = eng.generate(prompts, max_new=args.max_new)
            dt = time.perf_counter() - t0
            n_tok = len(prompts) * args.max_new
            print(f"tier {tier!r}: {eng.n_packed_leaves} packed leaves, "
                  f"{rep['bits'] / 8e3:.1f} kB weights, {n_tok / dt:.1f} tok/s on {device}")
            for p, o in zip(prompts, outs[tier], strict=True):
                print(f"    prompt={p} -> {o}")
    return outs


if __name__ == "__main__":
    main()
