"""The repo's other dense configs in the port, against the JAX package.

phi4-mini-3.8b, qwen3-14b and deepseek-7b at their smoke configs, plus a
test-only qwen3 variant with ``head_dim`` = 32, which differs from
d_model / n_heads = 16 (qwen3-14b's own 128 equals 5120 / 40), and
qwen3-14b's ``rope_theta`` = 1e6 (the smoke configs keep 1e4).  Together
they bring what smollm-135m does not: qk_norm on the decode, prefill and
verify paths, ``head_dim`` != d/h, ``rope_theta`` = 1e6, a GQA group of
one (deepseek's ``n_kv == n_heads``) and a 512-entry vocab (phi4's smoke
head).

* ``CONFIG`` and ``SMOKE_CONFIG`` equal the JAX package's field for field;
* the JAX package's initial params, carried across by
  ``convert.params_from_numpy``, give prefill and decode logits within
  atol = rtol = 1e-4 (two f32 computations that sum in different orders);
* one compressed train step gives the JAX loss within rtol 1e-5 and the
  same gradient wire bytes;
* an artifact the port writes serves the JAX engine's greedy tokens at
  mixed tiers, with staggered arrivals and a speculating request, and so
  does an artifact the JAX package writes: both directions.

The JAX config modules load only inside :func:`jax_config_scope`:
hypothesis draws example constants from every loaded local module, so a
config module left loaded here would change the JAX property tests'
examples in this xdist worker.
"""
import contextlib
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import api as japi
from repro.configs.base import get_arch as jget_arch
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamW
from repro.optim import GradCompressionConfig as JGC
from repro.train.state import train_state_descs as jstate_descs
from repro.train.step import make_cache_prefill_step as jprefill_step
from repro.train.step import make_train_step as jmake_train_step

ARCHS = ["phi4_mini_3_8b", "qwen3_14b", "deepseek_7b"]
VARIANTS = ARCHS + ["qwen3_14b_hd32"]
TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE = dict(quality="mid", batch_slots=3, max_prompt=8, max_len=24)


@contextlib.contextmanager
def jax_config_scope():
    """Drop every ``repro.configs`` module first imported inside the block
    from ``sys.modules`` on exit (see the module docstring)."""
    before = set(sys.modules)
    try:
        yield
    finally:
        for name in [m for m in sys.modules
                     if m not in before and m.startswith("repro.configs.")]:
            del sys.modules[name]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, TModel, tinit, toptim, tstep
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch import optim as toptim
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.train import step as tstep
        yield


def _cfgs(variant):
    """(JAX config, port config) of a variant's smoke config."""
    arch = variant.removesuffix("_hd32")
    with jax_config_scope():
        jcfg = jget_arch(arch, smoke=True)
    tcfg = tconfigs.get_arch(arch, smoke=True)
    if variant.endswith("_hd32"):
        jcfg = dataclasses.replace(jcfg, head_dim=32, rope_theta=1e6)
        tcfg = dataclasses.replace(tcfg, head_dim=32, rope_theta=1e6)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=VARIANTS)
def world(request):
    """The variant's two models and the JAX package's initial params (seed
    0) as numpy leaves."""
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = JModel(jcfg), TModel(tcfg)
    params = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0), jm.param_descs()))
    return request.param, jm, tm, params


def _fields(cfg) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["dtype"] = np.dtype(d["dtype"]).name if not isinstance(d["dtype"], torch.dtype) \
        else str(d["dtype"]).removeprefix("torch.")
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    assert arch in tconfigs.ARCH_IDS
    for smoke in (False, True):
        with jax_config_scope():
            j = _fields(jget_arch(arch, smoke=smoke))
        assert j == _fields(tconfigs.get_arch(arch, smoke))
    full = tconfigs.get_arch(arch)
    assert full.source == {"phi4_mini_3_8b": "arXiv:2412.08905; hf",
                           "qwen3_14b": "hf:Qwen/Qwen3-14B; hf",
                           "deepseek_7b": "arXiv:2401.02954; hf"}[arch]
    assert full.dtype == torch.bfloat16 and full.hd == 128


def test_prefill_and_decode_logits_match_jax(world):
    _, jm, tm, params = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    b, s, t = 3, 8, 16
    lens = np.array([8, 3, 5], np.int32)
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(0, tm.cfg.vocab, size=n)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(b, t))
    jprefill = jax.jit(jprefill_step(jm), static_argnums=(5,))
    jc, jl = jprefill(jp, jc, jnp.asarray(toks), jnp.asarray(lens), None, None)
    tc = tinit(tm.cache_descs(b, t), device="cpu")
    tc, tl = tm.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdecode = jax.jit(lambda p, c, tok, act: jm.decode(p, c, {"tokens": tok, "active": act}))
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    active = np.array([1, 0, 1], np.int32)
    for _ in range(3):
        jlg, jc = jdecode(jp, jc, jnp.asarray(cur), jnp.asarray(active))
        tlg, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(cur),
                                     "active": torch.from_numpy(active)})
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), **TOL)
        np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))
        cur = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)[:, None]


def test_compressed_train_step_matches_jax(world):
    _, jm, tm, _ = world
    jstate = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(3), jstate_descs(jm, JGC(enabled=True))))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.concatenate([toks[:, 1:], toks[:, :1]], 1)}
    jfn = jax.jit(jmake_train_step(jm, JAdamW(lr=1e-3), JGC(enabled=True), total_steps=5))
    tfn = tstep.make_train_step(tm, toptim.AdamWConfig(lr=1e-3),
                                toptim.GradCompressionConfig(enabled=True), total_steps=5)
    _, jmet = jfn(jax.tree_util.tree_map(jnp.asarray, jstate),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    _, tmet = tfn(tconvert.train_state_from_numpy(jstate, "cpu"),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    assert tmet["grad_wire_bytes"] == float(jmet["grad_wire_bytes"]) > 0


def _prompts(vocab, seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(1, 9))).tolist() for _ in range(n)]


def _stream(eng, mod, vocab):
    """Staggered mixed-tier arrivals, one request speculating from "lo"."""
    prompts = _prompts(vocab, 5)
    tiers = ["hi", "lo", "mid", "hi", "mid"]
    rids = [eng.submit(p, max_new=5, quality=q) for p, q in zip(prompts[:3], tiers)]
    eng.step()
    rids.append(eng.submit(prompts[3], max_new=4, quality=tiers[3]))
    rids.append(eng.submit(prompts[4], max_new=6, quality=tiers[4],
                           speculate=mod.SpecConfig(draft_tier="lo", k=2)))
    eng.run_until_drained()
    out = []
    for r in rids:
        st = eng.poll(r)
        out.append((st.finish_reason.value, tuple(st.tokens), st.quality))
    return out, eng.stream_stats()


def _serve_both(path, vocab):
    j = _stream(japi.load(path).engine(**ENGINE), japi, vocab)
    t = _stream(tapi.load(path).engine(device="cpu", **ENGINE), tapi, vocab)
    assert t == j
    assert all(r[0] == "done" for r in j[0]) and j[1]["drafted"] > 0


def test_port_artifact_serves_jax_tokens(world, tmp_path):
    _, _, tm, params = world
    art = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"), device="cpu")
    _serve_both(art.save(tmp_path / "port.edge.npz"), tm.cfg.vocab)


def test_jax_artifact_serves_port_tokens(world, tmp_path):
    _, jm, tm, params = world
    art = japi.compress(jm, jax.tree_util.tree_map(jnp.asarray, params))
    path = art.save(tmp_path / "jax.edge.npz")
    assert tapi.load(path).arch_config == tm.cfg
    _serve_both(path, tm.cfg.vocab)
