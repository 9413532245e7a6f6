"""The port stands alone: no JAX and nothing of the JAX package.

* An AST scan finds no import of ``jax`` or ``repro`` in any file under
  ``src/repro_torch/``, ``examples/torch_*.py`` or ``chip_smoke.py``.
* ``import repro_torch.api`` succeeds in a fresh interpreter where
  ``import jax`` is made to fail.
* An entry point called without ``device`` on a machine without CUDA
  raises instead of running on the CPU (``compress``, the engine,
  ``EdgeArtifact.tree``, ``unpack_pytree_wire``, the ``Trainer`` and the
  training launcher); a kernel wrapper runs its plain
  version only for CPU tensors and refuses any other device.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


@pytest.fixture(scope="module", autouse=True)
def _port():
    """The tests below import the port; keep it to this file (see
    ``torch_port_scope``)."""
    with port_modules():
        yield


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
            elif node.args and isinstance(node.args[0], ast.JoinedStr):
                head = node.args[0].values[0]
                if isinstance(head, ast.Constant):
                    roots.add(str(head.value).split(".")[0])
    return roots


def test_port_file_list_is_complete():
    names = {p.name for p in PORT_FILES}
    assert {"api.py", "engine.py", "store.py", "qsq.py", "chip_smoke.py", "trainer.py",
            "manager.py", "pipeline.py", "compression.py", "adamw.py", "cnn.py", "csd.py",
            "energy.py", "pytree.py", "packed.py", "graphs.py", "retrace.py",
            "phi4_mini_3_8b.py", "qwen3_14b.py", "deepseek_7b.py", "qwen3_moe_30b_a3b.py",
            "mixtral_8x22b.py", "torch_serve_lm.py", "torch_train_lm.py", "ssm.py",
            "mamba_lm.py", "hybrid.py", "mamba2_1_3b.py", "jamba_1_5_large_398b.py",
            "encdec.py", "llama_3_2_vision_11b.py", "whisper_tiny.py"} <= names
    assert ROOT / "src" / "repro_torch" / "launch" / "train.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "analysis" / "retrace.py" in PORT_FILES
    assert len(PORT_FILES) > 20


def test_no_jax_or_reference_import():
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & {"jax", "jaxlib", "repro"})
           for p in PORT_FILES}
    assert not {p: b for p, b in bad.items() if b}


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.api, repro_torch.serve.engine, repro_torch.kernels.build\n"
        "import repro_torch.train.trainer, repro_torch.launch.train, repro_torch.kernels\n"
        "import repro_torch.models.cnn, repro_torch.core.csd, repro_torch.quant.packed\n"
        "import repro_torch.train.cnn, repro_torch.serve.graphs, repro_torch.analysis\n"
        "import repro_torch.configs.phi4_mini_3_8b, repro_torch.configs.qwen3_14b\n"
        "import repro_torch.configs.deepseek_7b, repro_torch.configs.mixtral_8x22b\n"
        "import repro_torch.configs.mamba2_1_3b, repro_torch.configs.jamba_1_5_large_398b\n"
        "import repro_torch.models.hybrid, repro_torch.models.encdec\n"
        "import repro_torch.configs.llama_3_2_vision_11b, repro_torch.configs.whisper_tiny\n"
        "assert not [m for m in sys.modules if sys.modules[m] is not None\n"
        "            and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_arch("smollm_135m", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(model.param_descs())
    params = init_params(model.param_descs(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.compress(model, params)
    art = api.compress(model, params, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        art.engine(quality="hi", batch_slots=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        art.tree()
    assert art.tree(device="cpu")
    from repro_torch.quant import pytree

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pytree.unpack_pytree_wire(art.wire)
    assert pytree.unpack_pytree_wire(art.wire, device="cpu").tree
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer, TrainerConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, TrainerConfig(total_steps=1), lambda step: {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--steps", "1"])


def test_kernel_wrapper_refuses_other_devices():
    """The wrappers take CUDA, CPU and meta tensors (meta: the dry run's
    shapes-only route), on one device: a tensor on any other device, or
    operands on two devices, raise."""
    from repro_torch.kernels import qsq

    class Elsewhere(torch.Tensor):  # a tensor that reports another device
        @property
        def device(self):
            return torch.device("xpu")

    x = torch.zeros((2, 32)).as_subclass(Elsewhere)
    planes = torch.zeros((3, 1, 8), dtype=torch.int32).as_subclass(Elsewhere)
    scales = torch.zeros((2, 8)).as_subclass(Elsewhere)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        qsq.qsq_matvec(x, planes, scales, group_size=16, plane_major=True)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        qsq.qsq_quantize(torch.zeros((4, 8)).as_subclass(Elsewhere), group_size=2)
    with pytest.raises(ValueError, match="different devices"):
        qsq.qsq_matvec(torch.zeros((2, 32), device="meta"),
                       torch.zeros((3, 1, 8), dtype=torch.int32), torch.zeros((2, 8)),
                       group_size=16, plane_major=True)
