"""The port's serving launcher, ``python -m repro_torch.launch.serve``.

Runs on the smoke config with ``--device cpu`` (the plain PyTorch path):
a speculative stream (``--wire --stream --speculate lo:4``), packed
against ``--dense`` serving of one artifact (the same greedy tokens),
mixed tiers with QualityShed, the windowed mixtral-8x22b smoke config,
and the JAX launcher's flag checks; the default device is the card, so
without CUDA it raises.  The port's serving and training examples
(``examples/torch_serve_lm.py``, ``examples/torch_train_lm.py``) run once
each at their smoke size with ``--device cpu``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global serve
    with port_modules():
        from repro_torch.launch import serve
        yield


def _token_lines(out: str) -> list[str]:
    """The emitted token list of every finished request, in print order."""
    return [ln.split("->")[1].split("]")[0].strip() + "]" for ln in out.splitlines()
            if "->" in ln]


def test_stream_speculate_runs(capsys):
    eng = serve.main(["--wire", "--stream", "--speculate", "lo:4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "speculative: drafted" in out and "[spec " in out
    stats = eng.stream_stats()
    assert stats["drafted"] > 0 and 0 <= stats["accepted"] <= stats["drafted"]
    done = eng.completed_requests
    assert len(done) == 6 and all(len(r.out) == 16 for r in done.values())
    assert out.count(" done ") == 6


def test_speculative_stream_tokens_equal_plain_stream(capsys):
    serve.main(["--wire", "--stream", "--speculate", "mid:3", "--device", "cpu"])
    spec = _token_lines(capsys.readouterr().out)
    serve.main(["--wire", "--stream", "--device", "cpu"])
    plain = _token_lines(capsys.readouterr().out)
    assert spec == plain and len(plain) == 6


def test_dense_serves_packed_tokens(capsys):
    eng = serve.main(["--wire", "--dense", "--device", "cpu"])
    dense = capsys.readouterr().out
    assert "0 leaves served packed" in dense and eng.n_packed_leaves == 0
    serve.main(["--wire", "--device", "cpu"])
    packed = _token_lines(capsys.readouterr().out)
    assert _token_lines(dense) == packed and len(packed) == 3


def test_mixed_tiers_with_slo_runs(capsys):
    serve.main(["--wire", "--stream", "--mixed-tiers", "--slo", "20", "--max-queue", "4",
                "--deadline", "40", "--prompts", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "@lo" in out and "@hi" in out
    assert "tokens / 8 requests" in out


def test_windowed_arch_streams(capsys):
    """mixtral-8x22b's smoke config (window 32): a mixed-tier stream whose
    prompts and 40 new tokens outgrow the ring."""
    eng = serve.main(["--arch", "mixtral_8x22b", "--wire", "--stream", "--mixed-tiers",
                      "--max-new", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert eng.model.cfg.window == 32 and eng._session.cache.kv.k.shape[2] == 32
    done = eng.completed_requests
    assert done and all(len(r.out) == 40 for r in done.values())
    assert out.count(" done ") == len(done)


def test_examples_run_on_the_cpu(capsys):
    """``examples/torch_serve_lm.py`` (mixtral-8x22b's smoke config, every
    tier) and ``examples/torch_train_lm.py`` (3 steps, a checkpoint, the
    wire export) at ``--device cpu``; the example modules leave
    ``sys.modules`` again (see ``torch_port_scope``)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_lm
        import torch_train_lm

        outs = torch_serve_lm.main(["--arch", "mixtral_8x22b", "--max-new", "4",
                                    "--device", "cpu"])
        tr = torch_train_lm.main(["--steps", "3", "--batch", "2", "--seq", "16", "--device",
                                  "cpu"])
    finally:
        sys.path.remove(str(ROOT / "examples"))
        for name in ("torch_serve_lm", "torch_train_lm"):
            sys.modules.pop(name, None)
    assert set(outs) == {"hi", "mid", "lo"}
    assert all(len(o) == 3 and all(len(t) == 4 for t in o) for o in outs.values())
    assert len(tr.metrics_log) == 3 and all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    out = capsys.readouterr().out
    assert "channel payload" in out and "wire export" in out


@pytest.mark.parametrize("argv", [
    ["--speculate", "lo:4"],                                  # needs --wire --stream
    ["--wire", "--stream", "--speculate", "hi"],              # not below the serving tier
    ["--wire", "--stream", "--speculate", "lo:0"],            # empty window
    ["--wire", "--stream", "--speculate", "lo:x"],            # not an integer
    ["--wire", "--stream", "--mixed-tiers", "--speculate", "lo"],
    ["--wire", "--dense", "--mixed-tiers", "--stream"],
    ["--deadline", "3"],                                      # needs --stream
    ["--prompts", "9"],                                       # static batch > slots
])
def test_flag_errors(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2


def test_module_entry_point_and_default_device():
    """``python -m`` runs; the default ``--device cuda`` raises without CUDA."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--wire",
                          "--quality", "mid", "--max-new", "4", "--device", "cpu"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "serving tier 'mid'" in out.stdout and "12 tokens" in out.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--wire"])
