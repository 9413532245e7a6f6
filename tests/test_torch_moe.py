"""The MoE family in the port (qwen3-moe-30b-a3b), against the JAX package.

Everything runs at the qwen3-moe smoke config (2 layers, d 64, 8 experts
top-2, expert d_ff 32, qk_norm, f32).  Tolerances, with why:

* ``moe`` alone: the top-k indices, the kept assignments and their buffer
  positions bit for bit; outputs within atol = rtol = 1e-5 (two f32
  matmul orders); the aux loss within 1e-6.  ``torch.topk`` does not order
  equal values by index as ``jax.lax.top_k`` does, so every input here is
  checked to have no tie in the router's top-k + 1 probabilities;
* logits of the forward, prefill, decode and verify paths within
  atol = rtol = 1e-4, as for the dense configs; the loss (aux term
  included) within rtol 1e-5;
* one compressed train step: loss and gradient norm within rtol 1e-5 (the
  experts' gradients included), wire bytes exact;
* greedy engine tokens identical, on a mixed-tier stream with a
  speculating request, from an artifact of either package.

The dead-lane case first shows that its unmasked run competes for
capacity (the live lane's output changes), then holds the masked run
against the JAX package: the reference's own dead-lane test fails its
non-vacuity guard (ROADMAP Queue 3), so it is no oracle here.

The JAX config module is imported only inside ``jax_config_scope``,
and the port only inside ``port_modules``: hypothesis draws example
constants from every loaded local module, so a module left loaded here
would change the JAX property tests' examples in this xdist worker.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import jax_config_scope, port_modules

from repro import api as japi
from repro.configs.base import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamW
from repro.optim import GradCompressionConfig as JGC
from repro.train.state import train_state_descs as jstate_descs
from repro.train.step import make_train_step as jmake_train_step

ARCH = "qwen3_moe_30b_a3b"
TOL = dict(atol=1e-4, rtol=1e-4)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
ENGINE = dict(quality="mid", batch_slots=3, max_prompt=8, max_len=24)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, tlayers, TModel, tinit, toptim, tstep, no_recapture, \
        tserve, ttrain
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch import optim as toptim
        from repro_torch.analysis import no_recapture
        from repro_torch.launch import serve as tserve
        from repro_torch.launch import train as ttrain
        from repro_torch.models import layers as tlayers
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.train import step as tstep
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's (CONFIG, SMOKE_CONFIG) of qwen3-moe-30b-a3b."""
    with jax_config_scope():
        return jget_arch(ARCH), jget_arch(ARCH, smoke=True)


@pytest.fixture(scope="module")
def world(jcfgs):
    """Both smoke models and the JAX package's initial params (seed 0) as
    numpy leaves."""
    jm, tm = JModel(jcfgs[1]), TModel(tconfigs.get_arch(ARCH, smoke=True))
    params = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0), jm.param_descs()))
    return jm, tm, params


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _fields(cfg) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["moe"] = dataclasses.asdict(d["moe"])
    d["dtype"] = np.dtype(d["dtype"]).name if not isinstance(d["dtype"], torch.dtype) \
        else str(d["dtype"]).removeprefix("torch.")
    return d


def test_configs_equal_jax(jcfgs):
    assert ARCH in tconfigs.ARCH_IDS
    for j, smoke in zip(jcfgs, (False, True), strict=True):
        assert _fields(tconfigs.get_arch(ARCH, smoke)) == _fields(j)
    full = tconfigs.get_arch(ARCH)
    assert full.source == "hf:Qwen/Qwen3-30B-A3B; hf" and full.family == "moe"
    assert full.moe == tconfigs.MoEConfig(n_experts=128, top_k=8, capacity_factor=1.25)
    assert full.dtype == torch.bfloat16 and full.hd == 128 and full.window is None


# --------------------------------------------------------------------------
# moe against the JAX package's
# --------------------------------------------------------------------------
def _moe_params(seed, d=64, ff=32, e=8):
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, e), "wg": (e, d, ff), "wu": (e, d, ff), "wd": (e, ff, d)}
    scale = {"router": 0.3, "wg": 0.1, "wu": 0.1, "wd": 0.1}
    return {k: (rng.standard_normal(s) * scale[k]).astype(np.float32) for k, s in shapes.items()}


def _jax_routing(router, xt, top_k, cap, active, s):
    """The routing of ``src/repro/models/layers.py::moe`` with one shard,
    step for step in jnp: (top-k ids, kept, position) per assignment."""
    e = router.shape[-1]
    tl = xt.shape[0]
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, topi = jax.lax.top_k(probs, top_k)
    flat_e = topi.reshape(tl * top_k)
    if active is not None:
        act = jnp.broadcast_to(active.astype(bool)[:, None], (tl // s, s)).reshape(tl)
        flat_e = jnp.where(jnp.take(act, jnp.repeat(jnp.arange(tl), top_k)), flat_e, e)
    order = jnp.argsort(flat_e, stable=True)
    rank = jnp.argsort(order)
    starts = jnp.searchsorted(flat_e[order], jnp.arange(e), side="left")
    pos = rank - starts[jnp.minimum(flat_e, e - 1)]
    keep = (pos < cap) & (flat_e < e)
    return (np.asarray(topi).reshape(-1), np.asarray(keep), np.asarray(pos))


def _no_router_ties(p, x, top_k):
    probs = torch.softmax(_t(x).reshape(-1, x.shape[-1]) @ _t(p["router"]), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True).values[:, :top_k + 1]
    assert bool((top[:, :-1] > top[:, 1:]).all()), "a tie in the router's top-k"


def _both_moe(p, x, top_k, cf, active=None):
    """(JAX y, aux, routing), (port y, aux, routing) of one moe call."""
    b, s, _ = x.shape
    cap = int(np.ceil(b * s * top_k * cf / p["router"].shape[-1]))
    ja = None if active is None else _j(active)
    jy, jaux = jlayers.moe({k: _j(v) for k, v in p.items()}, _j(x), top_k=top_k,
                           capacity_factor=cf, active=ja)
    jr = _jax_routing(_j(p["router"]), _j(x).reshape(b * s, -1), top_k, cap, ja, s)
    ta = None if active is None else _t(active)
    ty, taux = tlayers.moe({k: _t(v) for k, v in p.items()}, _t(x), top_k=top_k,
                           capacity_factor=cf, active=ta)
    r, _ = tlayers.moe_route(_t(p["router"]), _t(x).reshape(b * s, -1), top_k=top_k,
                             cap=cap, active=ta)
    topi = torch.where(r.expert < p["router"].shape[-1], r.expert, -1)
    return (np.asarray(jy), float(jaux), jr), (ty.numpy(), float(taux),
                                               (topi.numpy(), r.keep.numpy(), r.pos.numpy()))


@pytest.mark.parametrize("b,s,cf", [(6, 1, 1.25), (2, 8, 1.25), (2, 8, 0.5)],
                         ids=["decode", "prefill", "overflow"])
def test_moe_matches_jax(b, s, cf):
    p = _moe_params(1)
    x = np.random.default_rng(2).standard_normal((b, s, 64)).astype(np.float32)
    _no_router_ties(p, x, 2)
    (jy, jaux, jr), (ty, taux, tr) = _both_moe(p, x, 2, cf)
    np.testing.assert_array_equal(tr[0], jr[0])  # top-k expert ids
    np.testing.assert_array_equal(tr[1], jr[1])  # kept within capacity
    np.testing.assert_array_equal(tr[2], jr[2])  # position in the expert's buffer
    np.testing.assert_allclose(ty, jy, **MOE_TOL)
    assert abs(taux - jaux) <= 1e-6
    if cf < 1:
        assert not tr[1].all(), "the overflow case must drop assignments"


def test_dead_lane_leaves_expert_competition():
    """Lanes 0 and 1 hold the same token, so they pick the same experts; at
    capacity 1 lane 0 (first in token order) takes every slot lane 1 wants.
    Unmasked, lane 1's output therefore changes with lane 0 (the
    competition this test needs); with lane 0 dead it does not compete, and
    the masked run equals the JAX package's."""
    p = _moe_params(3)
    x = np.random.default_rng(4).standard_normal((4, 1, 64)).astype(np.float32)
    x[0] = x[1]
    _no_router_ties(p, x, 2)
    active = np.array([0, 1, 1, 1], np.int32)
    (_, _, _), (free_y, _, free_r) = _both_moe(p, x, 2, 1.0)
    (jy, jaux, jr), (ty, taux, tr) = _both_moe(p, x, 2, 1.0, active)
    assert int(np.ceil(4 * 2 * 1.0 / 8)) == 1
    assert not free_r[1][2:4].any(), "unmasked, the dead lane takes lane 1's slots"
    assert not np.allclose(free_y[1], ty[1]), "the unmasked run must compete"
    assert tr[1][2:4].all() and not tr[1][:2].any()
    np.testing.assert_array_equal(tr[1], jr[1])
    np.testing.assert_array_equal(tr[2][tr[1]], jr[2][jr[1]])
    np.testing.assert_allclose(ty, jy, **MOE_TOL)
    np.testing.assert_array_equal(ty[0], 0.0)  # a dead lane's output is 0
    assert abs(taux - jaux) <= 1e-6


# --------------------------------------------------------------------------
# The model paths
# --------------------------------------------------------------------------
def test_forward_and_loss_match_jax(world):
    jm, tm, params = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    jl = jm.forward(jp, {"tokens": _j(toks)})
    tl = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    jloss = jm.loss(jp, {"tokens": _j(toks), "labels": _j(labels)})
    tloss = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    dense = jlayers.next_token_loss(jl, _j(labels))
    assert float(tloss) - float(dense) > 0.005, "the aux term is part of the loss"


def test_prefill_and_decode_logits_match_jax(world):
    jm, tm, params = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    b, s, t = 3, 8, 16
    lens = np.array([8, 3, 5], np.int32)
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(0, tm.cfg.vocab, size=n)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(b, t))
    jc, jl = jm.prefill(jp, jc, _j(toks), _j(lens))
    tc = tinit(tm.cache_descs(b, t), device="cpu")
    tc, tl = tm.prefill(tp, tc, _t(toks), _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    active = np.array([1, 0, 1], np.int32)
    for _ in range(3):
        jlg, jc = jm.decode(jp, jc, {"tokens": _j(cur), "active": _j(active)})
        tlg, tc = tm.decode(tp, tc, {"tokens": _t(cur), "active": _t(active)})
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), **TOL)
        np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))
        cur = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)[:, None]


def test_verify_logits_match_jax(port_path):
    """Prefill at per-lane tiers, then one verify pass whose window routes
    through each MoE block in one call (capacity from B x W, the lane
    that does not verify out of the competition), on served params."""
    jart, tart = japi.load(port_path), tapi.load(port_path)
    jm, tm = jart.model(), tart.model()
    jp, _ = jart.serve_params("hi", per_request=True)
    tp, _ = tart.serve_params("hi", per_request=True, device="cpu")
    prompts = [[5, 9, 2], [17], [3, 3, 8, 1]]
    toks = np.zeros((3, 6), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, 6 - len(pr):] = pr
    lens = np.array([len(pr) for pr in prompts], np.int32)
    tiers = np.array([0, 1, 2], np.int32)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 16))
    tc = tinit(tm.cache_descs(3, 16), device="cpu")
    jc, jl = jm.prefill(jp, jc, _j(toks), _j(lens), _j(tiers), 0)
    tc, tl = tm.prefill(tp, tc, _t(toks), _t(lens), _t(tiers), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    first = np.asarray(jnp.argmax(jl, -1))
    window = np.array([[first[0], 4, 8, 1], [first[1], 0, 0, 0], [first[2], 7, 7, 0]],
                      np.int32)
    wlen = np.array([4, 0, 3], np.int32)
    batch = dict(tokens=window, start=np.full((3,), 6, np.int32), wlen=wlen,
                 spec=(wlen > 0).astype(np.int32), tiers=tiers)
    jlg, jc2 = jm.verify(jp, jc, {**{k: _j(v) for k, v in batch.items()}, "demand": 0})
    tlg, tc2 = tm.verify(tp, tc, {**{k: _t(v) for k, v in batch.items()}, "demand": 0})
    np.testing.assert_allclose(tlg[[0, 2]].numpy(), np.asarray(jlg)[[0, 2]], **TOL)
    np.testing.assert_allclose(tc2.kv.k.numpy(), np.asarray(jc2.kv.k), **TOL)
    np.testing.assert_array_equal(tc2.kv.pos.numpy(), np.asarray(jc2.kv.pos))


def test_compressed_train_step_matches_jax(world):
    jm, tm, _ = world
    jstate = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(3), jstate_descs(jm, JGC(enabled=True))))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.concatenate([toks[:, 1:], toks[:, :1]], 1)}
    jfn = jax.jit(jmake_train_step(jm, JAdamW(lr=1e-3), JGC(enabled=True), total_steps=5))
    tfn = tstep.make_train_step(tm, toptim.AdamWConfig(lr=1e-3),
                                toptim.GradCompressionConfig(enabled=True), total_steps=5)
    jnew, jmet = jfn(jax.tree_util.tree_map(jnp.asarray, jstate),
                     {k: _j(v) for k, v in batch.items()})
    tnew, tmet = tfn(tconvert.train_state_from_numpy(jstate, "cpu"),
                     {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    assert tmet["grad_wire_bytes"] == float(jmet["grad_wire_bytes"]) > 0
    # the first moment holds the compressed gradient of each expert leaf and
    # the router: equal within 1e-4 of its largest value, save at most 0.1%
    # of values (a nearest-level near-tie can flip one code)
    for name in ("router", "wg", "wu", "wd"):
        j = np.asarray(jnew.opt.m["blocks"]["moe"][name])
        t = tnew.opt.m["blocks"]["moe"][name].numpy()
        assert np.abs(j).max() > 0
        off = np.abs(t - j) > 1e-4 * np.abs(j).max()
        assert off.mean() <= 1e-3, f"{name}: {int(off.sum())} of {off.size} values off"


# --------------------------------------------------------------------------
# Serving from an artifact of either package
# --------------------------------------------------------------------------
def _stream(eng, mod, vocab):
    """Staggered mixed-tier arrivals, one request speculating from "lo"."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(1, 9))).tolist() for _ in range(5)]
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


@pytest.fixture(scope="module")
def port_path(world, tmp_path_factory):
    _, tm, params = world
    art = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"), device="cpu")
    return art.save(tmp_path_factory.mktemp("moe") / "port.edge.npz")


@pytest.fixture(scope="module")
def jax_stream(port_path, world):
    """The JAX engine's stream on the port's artifact."""
    out = _stream(japi.load(port_path).engine(**ENGINE), japi, world[1].cfg.vocab)
    assert all(r[0] == "done" for r in out[0]) and out[1]["drafted"] > 0
    return out


def test_port_artifact_serves_jax_tokens(port_path, jax_stream, world):
    assert _stream(tapi.load(port_path).engine(device="cpu", **ENGINE), tapi,
                   world[1].cfg.vocab) == jax_stream


def test_jax_artifact_serves_port_tokens(world, tmp_path):
    jm, tm, params = world
    art = japi.compress(jm, jax.tree_util.tree_map(jnp.asarray, params))
    path = art.save(tmp_path / "jax.edge.npz")
    assert tapi.load(path).arch_config == tm.cfg
    want = _stream(japi.load(path).engine(**ENGINE), japi, tm.cfg.vocab)
    assert _stream(tapi.load(path).engine(device="cpu", **ENGINE), tapi, tm.cfg.vocab) == want
    assert want[1]["drafted"] > 0


def test_graph_keys_hold_static_args_only(port_path, jax_stream, world):
    """The MoE engine keys its steps by static arguments only, as for the
    dense family: never by slot, tiers or the active mask.  A second stream
    (admissions, evictions, re-tiered lanes) inside ``no_recapture`` adds
    no key and serves the JAX engine's tokens again."""
    eng = tapi.load(port_path).engine(device="cpu", **ENGINE)
    assert _stream(eng, tapi, world[1].cfg.vocab) == jax_stream
    keys = eng._session.graphs.keys()
    assert {k[0] for k in keys} == {"decode", "admit", "verify"}
    for key in keys:
        assert len(key) == (3 if key[0] == "verify" else 2), key
        assert all(isinstance(v, int) for v in key[1:]) and 0 <= key[1] <= 2, key
    with no_recapture(eng):
        eng.reset_stream()
        assert _stream(eng, tapi, world[1].cfg.vocab) == jax_stream
    assert eng._session.graphs.keys() == keys


def test_launchers_take_the_moe_arch(capsys):
    eng = tserve.main(["--arch", ARCH, "--wire", "--stream", "--speculate", "lo:2",
                       "--device", "cpu"])
    assert eng.model.cfg.moe is not None and eng.n_packed_leaves > 0
    assert "speculative: drafted" in capsys.readouterr().out
    tr = ttrain.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                      "--grad-compression", "--device", "cpu"])
    assert len(tr.metrics_log) == 2 and all(np.isfinite(m["loss"]) for m in tr.metrics_log)
