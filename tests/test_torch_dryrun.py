"""The port's dry run (``repro_torch.launch.dryrun``), against the JAX package
and against the same steps run on CPU tensors.

* The 40-cell support table, the shapes and every cell's input
  descriptors equal the JAX package's; so do ``model_flops_estimate`` and
  ``probe_config`` for all 40 cells, read from one subprocess: importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices, which
  ``tests/conftest.py`` keeps out of this process.
* MoE routing local to 4 data shards equals the JAX ``moe`` under rules for
  4 data shards (a subprocess with 4 host devices), within atol 1e-5 (two
  f32 matmul orders) and the aux loss within 1e-6; with no rules, or rules
  that leave one shard, the port's ``moe`` is the one-shard ``moe`` bit
  for bit.  The inputs have no tie in the router's top-k + 1.
* A meta trace of each family's smoke config, at small train, prefill and
  decode shapes, counts exactly the FLOPs, bytes, temp bytes, dispatch
  counters and plane traffic that the same step counts on CPU tensors
  (whose plain kernels' matmuls FlopCounterMode sees; on meta the wrappers
  add 2 M K N instead); its output descriptors hold the outputs' bytes.
* The probes' extrapolation equals the full trace of a dense config; the
  CLI writes one JSON a cell; a sharded mesh leaves the traced numbers
  null with reasons.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import jax_config_scope, port_modules

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import cell_is_supported as jcell_is_supported
from repro.configs.base import get_arch as jget_arch
from repro.models.api import Model as JModel

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train": (2, 16), "prefill": (2, 16), "decode": (2, 16)}  # (batch, seq / cache)
# JAX's result keys (src/repro/launch/dryrun.py run_cell)
JAX_KEYS = {"arch", "shape", "mesh", "chips", "supported", "lower_s", "compile_s", "probe_s",
            "probes_raw", "layer_extrapolation_ratio", "per_device", "model_flops",
            "n_params", "n_params_active", "useful_flops_ratio", "roofline"}
JAX_DEVICE_KEYS = {"flops", "bytes_accessed", "collective_bytes_extrapolated",
                   "collective_bytes_scan_module", "argument_bytes", "output_bytes",
                   "temp_bytes", "peak_bytes"}


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tbase, tconfigs, tdispatch, tdry, tlayers, tmesh, TModel, tqsq, FlopCounterMode
    with port_modules():
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch import configs as tconfigs
        from repro_torch.kernels import dispatch as tdispatch
        from repro_torch.kernels import qsq as tqsq
        from repro_torch.launch import dryrun as tdry
        from repro_torch.launch import mesh as tmesh
        from repro_torch.models import base as tbase
        from repro_torch.models import layers as tlayers
        from repro_torch.models.api import Model as TModel
        yield


@pytest.fixture(scope="module")
def jcfgs():
    with jax_config_scope():
        return {a: jget_arch(a) for a in J_ARCH_IDS}


def _run(script: str, *args, devices: int | None = None) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env,
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# --------------------------------------------------------------------------
# the cells, their inputs, their model FLOPs and probes: equal to JAX's
# --------------------------------------------------------------------------
def test_cell_table_matches_jax(jcfgs):
    assert sorted(tconfigs.ARCH_IDS) == sorted(J_ARCH_IDS)
    assert {k: tuple(vars(v).values()) for k, v in tconfigs.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in J_SHAPES.items()}
    table = {(a, s): tconfigs.cell_is_supported(tconfigs.get_arch(a), tconfigs.SHAPES[s])
             for a in J_ARCH_IDS for s in J_SHAPES}
    assert len(table) == 40 and sum(ok for ok, _ in table.values()) == 33
    assert table == {(a, s): jcell_is_supported(jcfgs[a], J_SHAPES[s])
                     for a in J_ARCH_IDS for s in J_SHAPES}


def test_input_descs_match_jax(jcfgs):
    def fields(d):
        return d.shape, d.axes, str(d.dtype).removeprefix("torch."), d.init

    for a in J_ARCH_IDS:
        jm, tm = JModel(jcfgs[a]), TModel(tconfigs.get_arch(a))
        for s in J_SHAPES:
            j, t = jm.input_descs(J_SHAPES[s]), tm.input_descs(tconfigs.SHAPES[s])
            assert sorted(j) == sorted(t), (a, s)
            assert {k: fields(v) for k, v in t.items()} == \
                {k: (*fields(v)[:2], np.dtype(v.dtype).name, v.init) for k, v in j.items()}


_JAX_FLOPS = """
import json, repro.launch.dryrun as D
from repro.configs import ARCH_IDS, SHAPES, get_arch
from repro.models.api import Model
out = {}
for a in ARCH_IDS:
    cfg = get_arch(a)
    for s in SHAPES:
        out[a + "/" + s] = list(D.model_flops_estimate(Model(cfg), SHAPES[s]))
    for m in (1, 2):
        c = D.probe_config(cfg, m)
        out[a + "/probe" + str(m)] = [c.n_layers, c.enc_layers, D.probe_granularity(cfg)]
print(json.dumps(out))
"""


def test_model_flops_and_probe_configs_match_jax():
    want = json.loads(_run(_JAX_FLOPS))
    got = {}
    for a in J_ARCH_IDS:
        cfg = tconfigs.get_arch(a)
        for s, shape in tconfigs.SHAPES.items():
            got[f"{a}/{s}"] = list(tdry.model_flops_estimate(TModel(cfg), shape))
        for m in (1, 2):
            c = tdry.probe_config(cfg, m)
            assert {k: v for k, v in vars(c).items() if k not in ("n_layers", "enc_layers")} \
                == {k: v for k, v in vars(cfg).items() if k not in ("n_layers", "enc_layers")}
            got[f"{a}/probe{m}"] = [c.n_layers, c.enc_layers, tdry.probe_granularity(cfg)]
    assert len(got) == 60 and got == want


# --------------------------------------------------------------------------
# MoE routing local to data shards
# --------------------------------------------------------------------------
_JAX_MOE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_debug_mesh, sharding_rules
from repro.models import layers
from repro.models.base import set_activation_rules
z = np.load(sys.argv[1])
mesh = make_debug_mesh(4, 1)
set_activation_rules(dict(sharding_rules(mesh)), mesh)
p = {k: jnp.asarray(z[k]) for k in ("router", "wg", "wu", "wd")}
fn = jax.jit(lambda p, x, a: layers.moe(p, x, top_k=2, capacity_factor=1.0, active=a))
out = {}
with mesh:
    for case, a in (("all", None), ("dead", jnp.asarray(z["active"]))):
        y, aux = fn(p, jnp.asarray(z["x"]), a)
        out[case + "_y"], out[case + "_aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def moe_case(tmp_path_factory):
    """8 lanes x 4 tokens (4 shards of 8 tokens, capacity 2 an expert in
    each), two lanes dead in the second case; JAX's outputs under 4 shards."""
    rng = np.random.default_rng(11)
    shapes = {"router": (64, 8), "wg": (8, 64, 32), "wu": (8, 64, 32), "wd": (8, 32, 64)}
    scale = {"router": 0.3, "wg": 0.1, "wu": 0.1, "wd": 0.1}
    p = {k: (rng.standard_normal(s) * scale[k]).astype(np.float32) for k, s in shapes.items()}
    x = rng.standard_normal((8, 4, 64)).astype(np.float32)
    active = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.int32)
    probs = torch.softmax(torch.from_numpy(x).reshape(32, 64) @ torch.from_numpy(p["router"]),
                          -1)
    top = torch.sort(probs, -1, descending=True).values[:, :3]
    assert bool((top[:, :-1] > top[:, 1:]).all()), "a tie in the router's top-k"
    d = tmp_path_factory.mktemp("moe")
    np.savez(d / "in.npz", x=x, active=active, **p)
    _run(_JAX_MOE, d / "in.npz", d / "out.npz", devices=4)
    return p, x, active, dict(np.load(d / "out.npz"))


def _tmoe(p, x, active=None):
    y, aux = tlayers.moe({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                         top_k=2, capacity_factor=1.0,
                         active=None if active is None else torch.from_numpy(active))
    return y.numpy(), float(aux)


@pytest.mark.parametrize("case", ["all", "dead"])
def test_moe_shard_local_routing_matches_jax(moe_case, case):
    p, x, active, want = moe_case
    a = active if case == "dead" else None
    one_y, _ = _tmoe(p, x, a)
    mesh = tmesh.make_debug_mesh(4, 1)
    tbase.set_activation_rules(tmesh.sharding_rules(mesh), mesh)
    try:
        assert tbase.data_shard_count() == 4
        y, aux = _tmoe(p, x, a)
    finally:
        tbase.set_activation_rules(None)
    np.testing.assert_allclose(y, want[f"{case}_y"], atol=1e-5, rtol=1e-5)
    assert abs(aux - float(want[f"{case}_aux"])) <= 1e-6
    assert not np.allclose(y, one_y), "shard-local capacity must change the routing here"
    if case == "dead":
        np.testing.assert_array_equal(y[[2, 6]], 0.0)


def test_moe_with_one_shard_is_unchanged(moe_case):
    """Rules of one card, and 4 data shards where the tokens do not split
    (t % 4 != 0) or split too small (t // 4 < max(top_k, 4)), route as one
    shard: the output equals the no-rules ``moe`` bit for bit."""
    p, x, active, _ = moe_case
    for mesh, xs, a in ((tmesh.make_debug_mesh(1, 1), x, active),
                        (tmesh.make_debug_mesh(4, 1), x[:2, :3], active[:2]),
                        (tmesh.make_debug_mesh(4, 1), x[:2], None)):
        want = _tmoe(p, xs, a)
        tbase.set_activation_rules(tmesh.sharding_rules(mesh), mesh)
        try:
            got = _tmoe(p, xs, a)
        finally:
            tbase.set_activation_rules(None)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# --------------------------------------------------------------------------
# the meta route of the kernels' wrappers
# --------------------------------------------------------------------------
def test_meta_route_of_the_wrappers():
    meta = dict(device="meta")
    m, k, n, g = 8, 256, 96, 16
    x = torch.empty((m, k), dtype=torch.bfloat16, **meta)
    pm = torch.empty((3, k // 32, n), dtype=torch.int32, **meta)
    il = torch.empty((k // 32, 3, n), dtype=torch.int32, **meta)
    sc = torch.empty((k // g, n), dtype=torch.float32, **meta)
    mask = torch.empty((m,), dtype=torch.int32, **meta)
    kw = dict(group_size=g, sign_mag=True, plane_major=True)
    # record_counts leaves the counters as they were and yields what the calls added
    with tdispatch.record_counts() as delta:
        outs = [tqsq.qsq_matvec(x, pm, sc, demand_drop=1, **kw),
                tqsq.qsq_matvec_masked(x, mask, pm, sc, demand_drop=2, **kw),
                tqsq.qsq_matmul(x, il, sc, group_size=g),
                tqsq.qsq_matmul_masked(x, mask, il, sc, group_size=g)]
        codes, scales = tqsq.qsq_quantize(torch.empty((k, n), **meta), group_size=g)
    for o in outs:
        assert o.device.type == "meta" and o.shape == (m, n) and o.dtype == torch.float32
    assert codes.shape == (k, n) and codes.dtype == torch.uint8 and codes.is_meta
    assert scales.shape == (k // g, n) and scales.dtype == torch.float32 and scales.is_meta
    _, _, launched, work = delta
    # the planes each call streams: 2, 1, 3, 3; x, scales, output (and masks) once
    operands = m * k * 2 + (k // g) * n * 4 + m * n * 4
    assert work["flops"] == 4 * 2 * m * k * n
    assert work["bytes"] == (4 * operands + 2 * 4 * m + (2 + 1 + 3 + 3) * (k // 32) * n * 4
                             + k * n * 4 + k * n + (k // g) * n * 4)
    assert not launched
    # the card's checks hold on meta, and mixed devices still refuse
    with pytest.raises(ValueError, match="M <= 16"):
        tqsq.qsq_matvec(torch.empty((17, k), dtype=torch.bfloat16, **meta), pm, sc,
                        group_size=g, plane_major=True)
    with pytest.raises(ValueError, match="different devices"):
        tqsq.qsq_matmul(x, il.new_empty(il.shape, device="cpu"), sc, group_size=g)
    with pytest.raises(TypeError):
        tqsq.qsq_matmul(x, il.to(torch.int64), sc, group_size=g)


# --------------------------------------------------------------------------
# meta traces against the same steps on CPU tensors
# --------------------------------------------------------------------------
def _cpu_trace(cell):
    """trace_cell's numbers for the cell run on seeded CPU tensors, and the
    bytes of the step's outputs."""
    gen = torch.Generator().manual_seed(0)
    args = [tbase.init_params(d, gen, device="cpu") for d in cell.descs]
    with tdispatch.record_counts() as delta:
        with FlopCounterMode(display=False) as fc, tdry._Trace() as tr:
            out = cell.step(*args)
    out_bytes = sum(t.numel() * t.element_size()
                    for t in tdry._tensors(out) if isinstance(t, torch.Tensor))
    assert not +delta[2] and not +delta[3]  # no launch, and nothing the wrappers add
    assert tr.host_bytes == 0
    return {"flops": fc.get_total_flops(), "bytes": tr.bytes, "temp_bytes": tr.peak,
            "counters": dict(+delta[0]), "traffic": dict(+delta[1])}, out_bytes


def _same_step(meta, cpu):
    """Equal counts, but for the host tables a step copies to its device
    each call (whisper's sinusoids), which on the CPU stay where they are:
    on meta each such copy reads and writes its (f32) bytes and holds a
    new storage."""
    host = meta.pop("host_bytes")
    assert meta.pop("bytes") == cpu.pop("bytes") + 2 * host
    t_meta, t_cpu = meta.pop("temp_bytes"), cpu.pop("temp_bytes")
    assert t_cpu <= t_meta <= t_cpu + host and t_meta > 0
    assert meta == cpu


@pytest.mark.parametrize("arch", ["smollm_135m", "qwen3_moe_30b_a3b", "mamba2_1_3b",
                                  "jamba_1_5_large_398b", "whisper_tiny",
                                  "llama_3_2_vision_11b"])
def test_meta_trace_equals_cpu_run(arch):
    cfg = tconfigs.get_arch(arch, smoke=True)
    rules = tmesh.sharding_rules(tmesh.make_debug_mesh())
    sizes = tmesh.mesh_axis_sizes(tmesh.make_debug_mesh())
    cells = {kind: tdry.build_cell(arch, tconfigs.ShapeConfig(f"small_{kind}", s, b, kind),
                                   cfg_override=cfg) for kind, (b, s) in SMALL.items()}
    tdry.trace_cell(cells["decode"])  # fills the per-device caches (RoPE, level tables)
    for kind, cell in cells.items():
        meta = tdry.trace_cell(cell)
        cpu, out_bytes = _cpu_trace(cell)
        assert meta["flops"] > 0
        _same_step(meta, cpu)
        assert sum(tdry.device_bytes(d, rules, sizes) for d in cell.out_descs) == out_bytes


def test_packed_meta_trace_counts_the_kernels():
    """deepseek-7b's smoke config widened to d 256 (so its projections,
    MLP and head reach packing's 65536 weights): on meta the wrappers add
    2 M K N a packed matmul, which on the CPU FlopCounterMode sees in the
    plain versions' products; counters and traffic agree."""
    cfg = dataclasses.replace(tconfigs.get_arch("deepseek_7b", smoke=True), d_model=256,
                              d_ff=512)
    cells = {kind: tdry.build_cell("deepseek_7b", tconfigs.ShapeConfig(kind, s, b, kind),
                                   cfg_override=cfg, packed=True)
             for kind, (b, s) in SMALL.items() if kind != "train"}
    tdry.trace_cell(cells["decode"])  # fills the per-device caches
    for kind, cell in cells.items():
        meta = tdry.trace_cell(cell)
        cpu, _ = _cpu_trace(cell)
        assert meta["flops"] == cpu["flops"]
        assert meta["counters"] == cpu["counters"] and meta["traffic"] == cpu["traffic"]
        assert meta["counters"][{"prefill": "gemm", "decode": "gemv"}[kind]] == \
            6 * cfg.n_layers + 1  # wq, wk, wv and the MLP a layer, and the head


def test_trace_follows_bytes_and_storages():
    x = torch.empty(1024, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    vals = torch.empty(4, device="meta")

    def step(x):
        a = x * 2           # 4 KiB live
        b = a + 1           # 8 KiB
        del a               # 4 KiB
        c = torch.cat([b, b.view(2, 512)[0]])  # 4 + 6 KiB: the peak
        b.index_put_((idx,), vals)  # indices and values read, values written
        return c.sum()

    with tdry._Trace() as tr:
        step(x)
    assert tr.peak == 4096 + 6144 + 4  # b, c and the sum
    assert tr.bytes == (4096 + 4096) + (4096 + 4096) + (4096 + 2048 + 6144) \
        + (32 + 16 + 16) + (6144 + 4)
    assert tr.cur == 0 and tr.host_bytes == 0


# --------------------------------------------------------------------------
# run_cell: probes, the CLI, sharded meshes
# --------------------------------------------------------------------------
def _extrapolate(result: dict, key: str) -> float:
    """The JAX dry run's extrapolation of its probes to full depth:
    X(L) = X(g) + (L/g - 1) * (X(2g) - X(g))."""
    x1, x2 = (p[key] for p in result["probes_raw"])
    return x1 + (result["layer_extrapolation_ratio"] - 1) * (x2 - x1)


def test_probe_extrapolation_equals_full_trace():
    for shape in (tconfigs.ShapeConfig("small_train", 32, 2, "train"),
                  tconfigs.ShapeConfig("small_decode", 256, 2, "decode")):
        r = tdry.run_cell("smollm_135m", shape, save=False)
        assert r["layer_extrapolation_ratio"] == 30
        assert _extrapolate(r, "flops") == r["per_device"]["flops"]
        assert _extrapolate(r, "bytes") == r["per_device"]["bytes_accessed"]


def test_cli_writes_one_json_per_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(tdry, "RESULTS_DIR", tmp_path)
    base = ["--arch", "smollm_135m", "--no-probes"]
    assert tdry.main(base + ["--shape", "decode_32k"]) == 0
    assert tdry.main(base + ["--shape", "long_500k"]) == 0
    assert tdry.main(base + ["--shape", "decode_32k", "--mesh", "16x16", "--tag", "t"]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["smollm_135m__decode_32k__16x16__t.json",
                     "smollm_135m__decode_32k__1x1.json", "smollm_135m__long_500k__1x1.json"]
    one = json.loads((tmp_path / files[1]).read_text())
    assert JAX_KEYS <= set(one) and JAX_DEVICE_KEYS <= set(one["per_device"])
    pd = one["per_device"]
    model = TModel(tconfigs.get_arch("smollm_135m"))
    assert pd["argument_bytes"] == (tbase.param_bytes(model.param_descs())
                                    + tbase.param_bytes(model.cache_descs(128, 32768))
                                    + 128 * 4)
    assert pd["peak_bytes"] == pd["argument_bytes"] + pd["temp_bytes"] > 80e9
    assert one["roofline"]["dominant"] == "memory" and one["probes_raw"] == []
    skip = json.loads((tmp_path / files[2]).read_text())
    assert not skip["supported"] and skip["skip_reason"].startswith("full quadratic")


def test_sharded_mesh_counts_arguments_and_leaves_the_trace_null():
    one = tdry.run_cell("smollm_135m", "decode_32k", save=False, probes_enabled=False)
    for mesh, kw in (("16x16", {}), ("2x16x16", {"multi_pod": True})):
        r = tdry.run_cell("smollm_135m", "decode_32k", mesh="16x16", save=False, **kw)
        assert r["mesh"] == mesh and r["chips"] == (256 if mesh == "16x16" else 512)
        pd = r["per_device"]
        for key in ("flops", "bytes_accessed", "temp_bytes", "peak_bytes",
                    "collective_bytes_extrapolated"):
            assert pd[key] is None and key in r["null_reasons"]
        assert r["roofline"] is None and r["useful_flops_ratio"] is None
        # the KV cache (batch over the data axes, sequence over "model") splits evenly
        cache = TModel(tconfigs.get_arch("smollm_135m")).cache_descs(128, 32768)
        rules = tmesh.sharding_rules(tdry.MESHES[mesh])
        sizes = tmesh.mesh_axis_sizes(tdry.MESHES[mesh])
        assert tdry.device_bytes(cache.kv.k, rules, sizes) * r["chips"] == \
            tbase.param_bytes(cache.kv.k)
        assert pd["argument_bytes"] < one["per_device"]["argument_bytes"] / 100
        assert r["model_flops"] == one["model_flops"]
