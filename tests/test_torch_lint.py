"""The port's qsqlint (``repro_torch.analysis``): QSQ001-QSQ005 over the port.

* The port's default paths lint clean.
* Each rule fires at the planted line of a fault planted in a copy of a
  real file (``serve/engine.py``, ``train/step.py``, ``kernels/qsq.py``),
  and the copy is clean before it is planted.
* The capture contexts on the real tree are the three ``StepGraphs.run``
  closures of the engine and the ten step-factory products of
  ``train/step.py``; on an eager CPU engine every function of those two
  files that runs inside ``StepGraphs.run`` is among them.
* The machinery shared with ``repro.analysis`` (pragmas, ``Violation``,
  allowlists, ``expr_taints``, QSQ001 and QSQ005) gives the same answers.
* The pragma forms and the CLI's exit codes.

``repro.analysis`` imports only the standard library; the port is imported
inside the module fixture (see ``torch_port_scope``).
"""
import ast
import shutil
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

from repro.analysis import astutil as j_astutil
from repro.analysis import config as j_config
from repro.analysis import linter as j_linter

ROOT = Path(__file__).resolve().parents[1]
PORT = "src/repro_torch"
ENGINE, STEP, QSQ = f"{PORT}/serve/engine.py", f"{PORT}/train/step.py", f"{PORT}/kernels/qsq.py"


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global ta, tastutil, tconfig, tlinter, tmain, tretrace, tapi, tget_arch, tinit, TModel, \
        StepGraphs
    with port_modules():
        from repro_torch import analysis as ta
        from repro_torch import api as tapi
        from repro_torch.analysis import astutil as tastutil
        from repro_torch.analysis import config as tconfig
        from repro_torch.analysis import linter as tlinter
        from repro_torch.analysis import retrace as tretrace
        from repro_torch.analysis.__main__ import main as tmain
        from repro_torch.configs import get_arch as tget_arch
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.serve.graphs import StepGraphs
        yield


def write(root: Path, rel: str, source: str) -> Path:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def copy_real(root: Path, *rels: str) -> None:
    for rel in rels:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, root / rel)


# --------------------------------------------------------------------------
# Self-lint
# --------------------------------------------------------------------------
def test_port_default_paths_lint_clean():
    vs, report = tlinter.lint_report(tconfig.default_paths(ROOT), root=ROOT)
    assert vs == [], "\n".join(v.format() for v in vs)
    # the two justified dense sites (models/layers.py W, models/api.py packed=False)
    assert report["pragmas"].get("QSQ001", 0) >= 2
    assert report["files"] > 100


# --------------------------------------------------------------------------
# Planted faults in copies of the real files
# --------------------------------------------------------------------------
_DECODE_LAMBDA = """\
        return s.graphs.run(
            ("decode", demand),
            lambda: self._cont_step(self.params, s.cache, cur, act, tr, demand)[0],
            restore=(s.cache.kv.pos,))"""
_CONT_RETURN = "        return torch.where(active > 0, nxt, cur[:, 0]), cache"
_MATMUL_LAUNCH = """\
    _check_cuda(x, planes, scales)
    return _launch("qsq_matmul", x, planes, scales, None, group_size, sign_mag,
                   plane_major, 3 - demand_drop)"""

# (files copied, file planted, anchor, replacement, marker of the flagged line, rule)
PLANTS = {
    "qsq001-as-dense-in-engine": (
        (ENGINE,), ENGINE, _DECODE_LAMBDA,
        "        w = self.params['embed'].as_dense()  # planted\n" + _DECODE_LAMBDA,
        "# planted", "QSQ001"),
    "qsq002-item-in-cont-step": (
        (ENGINE, STEP), STEP, _CONT_RETURN,
        "        first = nxt[0].item()  # planted\n" + _CONT_RETURN, "# planted", "QSQ002"),
    "qsq002-if-active-any-in-cont-step": (
        (ENGINE, STEP), STEP, _CONT_RETURN,
        "        if active.any():  # planted\n            nxt = nxt + 0\n" + _CONT_RETURN,
        "# planted", "QSQ002"),
    "qsq003-demand-dropped-from-decode-key": (
        (ENGINE, STEP), ENGINE, '            ("decode", demand),',
        '            ("decode",),  # planted', "# planted", "QSQ003"),
    "qsq003-tiers-in-decode-key": (
        (ENGINE, STEP), ENGINE, '            ("decode", demand),',
        '            ("decode", demand, tiers),  # planted', "# planted", "QSQ003"),
    "qsq003-put-result-in-admit-key": (
        (ENGINE, STEP), ENGINE, '            ("admit", demand),',
        '            ("admit", demand, tr),  # planted', "# planted", "QSQ003"),
    "qsq004-cpu-guard-removed": (
        (QSQ,), QSQ, "    if _on_cpu(x, planes, scales):\n        return ref.qsq_matmul_ref(",
        "    if x.dim() == 2:\n        return ref.qsq_matmul_ref(  # planted",
        "# planted", "QSQ004"),
    "qsq004-launch-failure-falls-back": (
        (QSQ,), QSQ, _MATMUL_LAUNCH,
        _MATMUL_LAUNCH.replace("    return _launch", "    try:\n        return _launch")
        .replace("                   plane_major", "                       plane_major")
        + "\n    except RuntimeError:  # planted\n"
          "        return ref.qsq_matmul_ref(x, planes, scales, group_size)",
        "# planted", "QSQ004"),
    "qsq005-counter-in-decode-closure": (
        (ENGINE, STEP), ENGINE, _DECODE_LAMBDA,
        "        def step():\n"
        "            dispatch.counters[\"gemv\"] += 1  # planted\n"
        "            return self._cont_step(self.params, s.cache, cur, act, tr, demand)[0]\n\n"
        "        return s.graphs.run((\"decode\", demand), step, restore=(s.cache.kv.pos,))",
        "# planted", "QSQ005"),
}


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_planted_fault_flagged_at_its_line(tmp_path, case):
    files, target, anchor, replacement, marker, rule = PLANTS[case]
    copy_real(tmp_path, *files)
    clean = ta.lint_paths(list(files), root=tmp_path)
    assert clean == [], "\n".join(v.format() for v in clean)
    src = (tmp_path / target).read_text()
    assert src.count(anchor) >= 1, f"anchor of {case} not in {target}"
    planted = src.replace(anchor, replacement, 1)
    (tmp_path / target).write_text(planted)
    compile(planted, target, "exec")  # the plant is valid Python
    line = next(i for i, text in enumerate(planted.splitlines(), 1) if marker in text)
    vs = ta.lint_paths(list(files), root=tmp_path)
    assert any(v.rule == rule and v.path == target and v.line == line for v in vs), \
        f"{rule} not at {target}:{line}:\n" + "\n".join(v.format() for v in vs)


# --------------------------------------------------------------------------
# Capture contexts
# --------------------------------------------------------------------------
RUN_CLOSURES = {(ENGINE, "ServeEngine._decode_call.<lambda>"),
                (ENGINE, "ServeEngine._admit_call.<lambda>"),
                (ENGINE, "ServeEngine._verify_call.verify")}
PRODUCTS = {(STEP, q) for q in (
    "make_train_step.train_step", "make_prefill_step.<lambda>", "make_serve_step.serve_step",
    "make_cache_prefill_step.prefill_step", "make_cache_prefill_step.scanned_prefill",
    "make_admit_step.admit", "make_cont_decode_step.cont_step", "make_verify_step.verify",
    "make_decode_loop.decode_loop", "make_sample_decode_loop.decode_loop")}


def test_capture_contexts_of_the_real_tree():
    found = ta.capture_contexts([PORT], root=ROOT)
    assert {(c["path"], c["qualname"]) for c in found} == RUN_CLOSURES | PRODUCTS
    assert len(found) == 13
    resolved = {c["qualname"] for c in found if "resolved" in c["reasons"]}
    assert resolved == {"make_cont_decode_step.cont_step", "make_admit_step.admit",
                        "make_verify_step.verify"}
    assert {(c["path"], c["qualname"]) for c in found
            if "run-closure" in c["reasons"]} == RUN_CLOSURES


def test_functions_run_under_stepgraphs_are_contexts(monkeypatch):
    """The CPU half of chip_smoke.py [17]: on an eager engine, what runs
    inside ``StepGraphs.run`` (decode, admission and a speculative verify)."""
    contexts = {(c["path"], c["qualname"]) for c in ta.capture_contexts([PORT], root=ROOT)}
    model = TModel(tget_arch("smollm_135m", smoke=True))
    params = tinit(model.param_descs(), torch.Generator().manual_seed(0), device="cpu")
    art = tapi.compress(model, params, device="cpu")
    eng = art.engine(quality="hi", batch_slots=2, max_prompt=8, max_len=32, device="cpu",
                     eager=True)
    entered: set = set()
    run = StepGraphs.run

    def recorded(self, key, fn, restore=()):
        with tretrace.entered_functions(ROOT) as calls:
            out = run(self, key, fn, restore)
        entered.update(calls)
        return out

    monkeypatch.setattr(StepGraphs, "run", recorded)
    rids = [eng.submit([5, 9, 2], max_new=5, quality="hi", speculate=tapi.SpecConfig("lo", 2)),
            eng.submit([17, 3], max_new=4, quality="mid")]
    eng.run_until_drained()
    assert all(eng.poll(r).tokens for r in rids)
    keys = {k[0] for k in eng._session.graphs.keys()}
    assert keys == {"decode", "admit", "verify"}
    ours = {e for e in entered if e[0] in (ENGINE, STEP)}
    assert RUN_CLOSURES <= ours, sorted(ours)
    assert ours <= contexts, sorted(ours - contexts)


# --------------------------------------------------------------------------
# Parity with repro.analysis on the shared machinery
# --------------------------------------------------------------------------
PRAGMA_SOURCES = [
    "x = 1  # qsqlint: disable=QSQ001 -- why\ny = 2\n",
    "# qsqlint: disable=QSQ002,QSQ003 -- why\n\n# more words\nz = f(1)\n",
    "# qsqlint: disable-file=QSQ005 -- seeds\na = 1  # qsqlint: disable=all\n",
    "s = '# qsqlint: disable=QSQ001'\nb = 2  #qsqlint:disable=QSQ004\n",
    "def f(:\n  # qsqlint: disable=QSQ001\n",
]
TAINT_EXPRS = ["x.shape[0]", "x.ndim", "x.dtype", "x.size", "x is None", "None is not x",
               "len(x)", "isinstance(x, int)", "getattr(x, 'a')", "x[0]", "y[x]", "x + 1",
               "f(x)", "x.sum()", "x == 0", "(x, 1)", "y", "lambda: x", "y.shape", "x.T",
               "[v for v in x]", "x if y else 0", "-x", "x.shape[0] + x[0]"]
ALLOW = ("QSQ001:src/*/serve/*.py", "QSQ005:tests/*:seed", "QSQ002:a.py:f.g", "bad")
ALLOW_QUERIES = [("QSQ001", "src/x/serve/e.py", "<module>"), ("QSQ001", "src/x/models/e.py", "f"),
                 ("QSQ005", "tests/t.py", "seed"), ("QSQ005", "tests/t.py", "T.seed"),
                 ("QSQ005", "tests/t.py", "reseed"), ("QSQ002", "a.py", "f.g"),
                 ("QSQ002", "a.py", "f"), ("QSQ003", "a.py", "f")]
SNIPPET = """\
from pkg import dispatch


def forward(p, x, tree):
    w = p.as_dense()
    dispatch.counters["gemv"] += 1
    dispatch.counters.clear()
    del dispatch.counters["x"]
    dispatch.traffic = {}
    return dense_tree(tree), w.dequantize() @ x


def reset():
    dispatch.counters.clear()
"""


@pytest.mark.parametrize("what", ["pragmas", "format", "allowlist", "taints", "qsq001-qsq005"])
def test_parity_with_the_jax_linter(tmp_path, what):
    if what == "pragmas":
        for src in PRAGMA_SOURCES:
            j, t = j_linter.parse_pragmas(src), tlinter.parse_pragmas(src)
            assert (t.file_rules, t.line_rules) == (j.file_rules, j.line_rules), src
    elif what == "format":
        fields = dict(path="src/a.py", line=3, col=7, rule="QSQ002", message="m `x`",
                      qualname="f.g")
        assert tlinter.Violation(**fields).format() == j_linter.Violation(**fields).format()
    elif what == "allowlist":
        jc, tc = j_config.Config(allow=ALLOW), tconfig.Config(allow=ALLOW)
        for q in ALLOW_QUERIES:
            assert tc.allowlisted(*q) == jc.allowlisted(*q), q
    elif what == "taints":
        for e in TAINT_EXPRS:
            node = ast.parse(e, mode="eval").body
            assert (tastutil.expr_taints(node, {"x"})
                    == j_astutil.expr_taints(node, {"x"})), e
    else:
        write(tmp_path, "pkg/hot.py", SNIPPET)
        kw = dict(select=("QSQ001", "QSQ005"), hot_paths=("pkg",),
                  counter_objects=("pkg.dispatch.counters", "pkg.dispatch.traffic"),
                  counter_scopes=("pkg/hot.py::reset",))
        j = j_linter.lint_paths(["pkg"], config=j_config.Config(**kw), root=tmp_path)
        t = ta.lint_paths(["pkg"], config=tconfig.Config(**kw), root=tmp_path)
        assert [(v.line, v.col, v.rule) for v in t] == [(v.line, v.col, v.rule) for v in j]
        assert len(t) == 7


# --------------------------------------------------------------------------
# Pragma forms and the CLI
# --------------------------------------------------------------------------
HOT = "src/repro_torch/serve/hot.py"
PRAGMA_FORMS = {
    "trailing": ("def f(p):\n    a = p.as_dense()  # qsqlint: disable=QSQ001 -- cold\n"
                 "    return p.as_dense(), a\n", [3]),
    "standalone": ("def f(p):\n    # qsqlint: disable=QSQ001 -- cold: the comment\n"
                   "    # runs on\n    a = p.as_dense()\n    return p.as_dense(), a\n", [5]),
    "disable-file": ("# qsqlint: disable-file=QSQ001 -- a cold module\n"
                     "def f(p):\n    return p.as_dense(), p.dequantize()\n", []),
    "all": ("def f(p):\n    a = p.as_dense()  # qsqlint: disable=all -- cold\n"
            "    return dense_tree(p), a\n", [3]),
}


@pytest.mark.parametrize("form", sorted(PRAGMA_FORMS))
def test_pragma_forms(tmp_path, form):
    src, lines = PRAGMA_FORMS[form]
    write(tmp_path, HOT, src)
    vs = ta.lint_paths([HOT], root=tmp_path)
    assert [v.line for v in vs] == lines and {v.rule for v in vs} <= {"QSQ001"}


def test_cli_exit_codes_and_rule_list(tmp_path, capsys):
    assert tmain(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert [ln.split()[0] for ln in listed.splitlines()] == list(tconfig.ALL_RULES)
    assert tconfig.ALL_RULES == ("QSQ001", "QSQ002", "QSQ003", "QSQ004", "QSQ005")
    write(tmp_path, HOT, "def f(p):\n    return p.as_dense()\n")
    write(tmp_path, "src/repro_torch/serve/ok.py", "def f(p):\n    return p\n")
    root = ["--root", str(tmp_path)]
    assert tmain([*root, "src/repro_torch/serve/ok.py"]) == 0
    assert tmain([*root, HOT]) == 1
    assert "QSQ001" in capsys.readouterr().out
    assert tmain([*root, "--ignore", "QSQ001", HOT]) == 0
    assert tmain([*root, "--select", "NOPE", HOT]) == 2
    assert tmain([*root, "--config", str(tmp_path / "missing.json"), HOT]) == 2
    write(tmp_path, "bad.py", "def f(:\n")
    assert tmain([*root, "bad.py"]) == 1  # a syntax error is reported, not raised
    assert "QSQ000" in capsys.readouterr().out
