"""Sliding-window attention in the port (mixtral-8x22b), against the JAX package.

The layers run at d 64, 4/2 heads of 16, f32, on inputs made with numpy
from a seed; the model paths at the mixtral smoke config (2 layers, d 64,
4 experts top-2, window 32, f32).  Tolerances, with why:

* ``causal_mask`` with a window: equal;
* ``attention`` on its three branches (one windowed mask, the
  ``(window + q_chunk)`` kv slices, q-chunks over the whole kv): outputs
  and the gradients of x and every weight within atol = rtol = 1e-5 (two
  f32 matmul and softmax orders);
* ``decode_attention`` on the ring, step by step for more than twice the
  window, and ``prefill_attention`` with the prompt inside and beyond the
  ring: outputs and the cache's k/v within 1e-5, ``pos``/``pad`` equal;
* logits of the model paths within atol = rtol = 1e-4, the loss within
  rtol 1e-5, as for the dense configs; one train step's loss and gradient
  norm within rtol 1e-5, and with compression the loss within 1e-5, the
  wire bytes exact and the encoded gradient's norm within 1e-3 (a code can
  flip at a near-tie of the encoder);
* greedy engine tokens identical to the JAX engine's, continuous (prompts
  wider than the ring, decode wrapping it) and static, from an artifact of
  either package.

The JAX config module is imported only inside ``jax_config_scope``, and the
port only inside ``port_modules`` (see ``torch_port_scope``).
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

ARCH = "mixtral_8x22b"
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
# prompts up to 40 tokens (wider than the 32-entry ring) and 30 new tokens:
# every admission keeps the prompt's last 32 tokens, every decode wraps
ENGINE = dict(quality="mid", batch_slots=3, max_prompt=40, max_len=71)
MAX_NEW = 30


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, tlayers, TModel, tinit, toptim, tstep, ttrain
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch import optim as toptim
        from repro_torch.launch import train as ttrain
        from repro_torch.models import layers as tlayers
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.train import step as tstep
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's (CONFIG, SMOKE_CONFIG) of mixtral-8x22b."""
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
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv, full.hd, full.d_ff,
            full.vocab, full.window, full.rope_theta) == \
        (56, 6144, 48, 8, 128, 16384, 32768, 4096, 1e6)
    assert full.moe == tconfigs.MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25)
    assert full.dtype == torch.bfloat16 and full.source == "arXiv:2401.04088; hf"
    smoke = tconfigs.get_arch(ARCH, smoke=True)
    assert smoke.window == 32 and smoke.dtype == torch.float32


# --------------------------------------------------------------------------
# The layers
# --------------------------------------------------------------------------
def test_causal_mask_matches_jax():
    for s, t, offset, window in ((8, 8, 0, None), (8, 8, 0, 3), (4, 16, 8, 5), (16, 48, 32, 16),
                                 (5, 5, 0, 1)):
        want = np.asarray(jlayers.causal_mask(s, t, offset=offset, window=window))
        got = tlayers.causal_mask(s, t, offset=offset, window=window).numpy()
        np.testing.assert_array_equal(got, want)


def _attn_params(seed, d=64, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    p = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in p.items()}


@pytest.mark.parametrize("s,q_chunk,window", [(32, 64, 8), (128, 32, 16), (64, 32, 48)],
                         ids=["one-mask", "kv-slices", "full-kv-chunks"])
def test_attention_branches_match_jax(s, q_chunk, window):
    """Values and gradients (x and every weight) of the windowed training
    attention on each of the JAX package's three branches."""
    p = _attn_params(1)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, s, 64)) * 0.5).astype(np.float32)
    r = rng.standard_normal((2, s, 64)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))

    def jloss(jp, jx):
        out = jlayers.attention(jp, jx, positions=_j(pos), window=window, q_chunk=q_chunk)
        return jnp.sum(out * _j(r)), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: _j(v) for k, v in p.items()}, _j(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    out = tlayers.attention(tp, tx, positions=_t(pos), window=window, q_chunk=q_chunk)
    torch.sum(out * _t(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **LAYER_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **LAYER_TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]), **LAYER_TOL)


def test_sliced_path_equals_masked_as_in_jax():
    """The JAX package's own case (``tests/test_models.py``): window 16 over
    128 positions, the kv-sliced path (q_chunk 32) against one windowed
    mask (q_chunk 128), in both packages."""
    p = _attn_params(4, d=32, h=4, kv=2, hd=8)
    x = (np.random.default_rng(4).standard_normal((2, 128, 32)) * 0.3).astype(np.float32)
    pos = np.tile(np.arange(128, dtype=np.int32), (2, 1))
    jp = {k: _j(v) for k, v in p.items()}
    want = np.asarray(jlayers.attention(jp, _j(x), positions=_j(pos), window=16, q_chunk=128))
    tp = {k: _t(v) for k, v in p.items()}
    for chunk in (32, 128):
        got = tlayers.attention(tp, _t(x), positions=_t(pos), window=16, q_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def _jcache(c):
    return jlayers.KVCache(k=_j(c.k), v=_j(c.v), pos=_j(c.pos), pad=_j(c.pad))


def _assert_cache(jc, tc):
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **LAYER_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **LAYER_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.pad.numpy(), np.asarray(jc.pad))


def _prefill_then_decode(s, t, lens, steps, dead):
    """Prefill an s-wide left-padded batch into a t-entry ring (window t),
    then ``steps`` decodes with lane ``dead[1]`` inactive over the steps
    in ``dead[0]``; outputs and the whole cache equal JAX's after each."""
    p = _attn_params(6)
    jp, tp = {k: _j(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(7)
    b = len(lens)
    lens = np.asarray(lens, np.int32)
    pad = (s - lens).astype(np.int32)
    x = (rng.standard_normal((b, s, 64)) * 0.5).astype(np.float32)
    positions = np.maximum(np.arange(s, dtype=np.int32)[None] - pad[:, None], 0)
    zero = tlayers.KVCache(k=torch.zeros((b, t, 2, 16)), v=torch.zeros((b, t, 2, 16)),
                           pos=torch.zeros((b,), dtype=torch.int32),
                           pad=torch.zeros((b,), dtype=torch.int32))
    jy, jc = jlayers.prefill_attention(jp, _j(x), _jcache(zero), positions=_j(positions),
                                       pad=_j(pad), window=t)
    ty, tc = tlayers.prefill_attention(tp, _t(x), zero, positions=_t(positions), pad=_t(pad),
                                       window=t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    _assert_cache(jc, tc)
    assert not zero.k.any(), "prefill must leave its input cache untouched"
    for i in range(steps):
        xi = (rng.standard_normal((b, 1, 64)) * 0.5).astype(np.float32)
        active = np.ones((b,), np.int32)
        if i in dead[0]:
            active[dead[1]] = 0
        jy, jc = jlayers.decode_attention(jp, _j(xi), jc, window=t, active=_j(active))
        ty, tc = tlayers.decode_attention(tp, _t(xi), tc, window=t, active=_t(active))
        live = active.astype(bool)
        np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live], **LAYER_TOL)
        _assert_cache(jc, tc)
    assert int(tc.pos.max()) > 2 * t


def test_decode_ring_matches_jax():
    """Prompts inside the 8-entry ring (6 wide, left pads 0/3/2), then 20
    decode steps: every lane wraps more than twice, lane 2 dead for 5."""
    _prefill_then_decode(s=6, t=8, lens=[6, 3, 4], steps=20, dead=(range(5, 10), 2))


def test_prefill_beyond_ring_then_decode_matches_jax():
    """Prompts 12 wide into an 8-entry ring (the last 8 tokens kept at slots
    i % 8; left pads 0/5/9, so pad entries survive in the ring), then 10
    decode steps with lane 0 dead for 3."""
    _prefill_then_decode(s=12, t=8, lens=[12, 7, 3], steps=10, dead=(range(2, 5), 0))


# --------------------------------------------------------------------------
# The model paths at the smoke config
# --------------------------------------------------------------------------
def test_forward_and_loss_match_jax(world):
    """48 positions through a window of 32: the mask drops the oldest keys."""
    jm, tm, params = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 48)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    jl = jm.forward(jp, {"tokens": _j(toks)})
    tl = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    jloss = jm.loss(jp, {"tokens": _j(toks), "labels": _j(labels)})
    tloss = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_prefill_and_decode_logits_match_jax(world):
    """Left-padded prompts 40 wide into the 32-entry ring, then 30 decode
    steps (70 positions, past twice the window) with a dead lane."""
    jm, tm, params = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    b, s = 3, 40
    lens = np.array([40, 13, 33], np.int32)
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(0, tm.cfg.vocab, size=n)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(b, 80))
    tc = tinit(tm.cache_descs(b, 80), device="cpu")
    assert tc.kv.k.shape[2] == 32
    jc, jl = jm.prefill(jp, jc, _j(toks), _j(lens))
    tc, tl = tm.prefill(tp, tc, _t(toks), _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdecode = jax.jit(jm.decode)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for i in range(30):
        active = np.array([1, int(not 10 <= i < 14), 1], np.int32)
        jlg, jc = jdecode(jp, jc, {"tokens": _j(cur), "active": _j(active)})
        tlg, tc = tm.decode(tp, tc, {"tokens": _t(cur), "active": _t(active)})
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        cur = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)[:, None]
    np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), **TOL)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))


def test_sliding_window_forgets_its_prefix(world):
    """The JAX package's SWA property (``tests/test_models.py``) on the port:
    decoding one 70-token suffix after two different prefixes converges,
    since context reaches back at most n_layers x window = 64 tokens."""
    _, tm, params = world
    tp = tconvert.params_from_numpy(params, "cpu")

    def run(tokens):
        cache = tinit(tm.cache_descs(1, 120), device="cpu")
        for t in tokens:
            logits, cache = tm.decode(tp, cache, {"tokens": torch.tensor([[t]],
                                                                          dtype=torch.int32)})
        return logits

    suffix = list(range(70))
    np.testing.assert_allclose(run([1, 2, 3] + suffix).numpy(),
                               run([9, 8, 7] + suffix).numpy(), **TOL)


def test_compressed_train_step_matches_jax(world):
    """One train step on 48-token rows (the window masks keys), without and
    with gradient compression.  Uncompressed, the gradient norm holds the
    windowed backward within rtol 1e-5.  Compressed, the loss does and the
    wire bytes are exact; the norm of the encoded gradient within rtol 1e-3,
    since the encoder's nearest-level rule can flip a code at a near-tie
    under last-bit gradient differences (here one code of ``embed.tok``
    moves it by 2.5e-4)."""
    jm, tm, _ = world
    jstate = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(3), jstate_descs(jm, JGC(enabled=True))))
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (2, 48)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.concatenate([toks[:, 1:], toks[:, :1]], 1)}
    for enabled, norm_rtol in ((False, 1e-5), (True, 1e-3)):
        jfn = jax.jit(jmake_train_step(jm, JAdamW(lr=1e-3), JGC(enabled=enabled),
                                       total_steps=5))
        tfn = tstep.make_train_step(tm, toptim.AdamWConfig(lr=1e-3),
                                    toptim.GradCompressionConfig(enabled=enabled),
                                    total_steps=5)
        _, jmet = jfn(jax.tree_util.tree_map(jnp.asarray, jstate),
                      {k: _j(v) for k, v in batch.items()})
        _, tmet = tfn(tconvert.train_state_from_numpy(jstate, "cpu"),
                      {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=norm_rtol)
        assert tmet["grad_wire_bytes"] == float(jmet["grad_wire_bytes"])
    assert tmet["grad_wire_bytes"] > 0


# --------------------------------------------------------------------------
# Serving from an artifact of either package
# --------------------------------------------------------------------------
def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=n).tolist() for n in (40, 7, 33, 21, 38)]


def _stream(eng, vocab):
    """Staggered mixed-tier arrivals, 30 new tokens each."""
    prompts = _prompts(vocab)
    tiers = ["hi", "lo", "mid", "hi", "mid"]
    rids = [eng.submit(p, max_new=MAX_NEW, quality=q) for p, q in zip(prompts[:3], tiers)]
    eng.step()
    rids += [eng.submit(p, max_new=MAX_NEW, quality=q) for p, q in zip(prompts[3:], tiers[3:])]
    eng.run_until_drained()
    return [(eng.poll(r).finish_reason.value, tuple(eng.poll(r).tokens)) for r in rids]


@pytest.fixture(scope="module")
def port_path(world, tmp_path_factory):
    _, tm, params = world
    art = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"), device="cpu")
    return art.save(tmp_path_factory.mktemp("swa") / "port.edge.npz")


@pytest.fixture(scope="module")
def jax_stream(port_path, world):
    """The JAX engine's stream on the port's artifact."""
    out = _stream(japi.load(port_path).engine(**ENGINE), world[1].cfg.vocab)
    assert all(r[0] == "done" and len(r[1]) == MAX_NEW for r in out)
    return out


def test_port_artifact_serves_jax_tokens(port_path, jax_stream, world):
    eng = tapi.load(port_path).engine(device="cpu", **ENGINE)
    assert eng._ensure_session().cache.kv.k.shape[2] == 32
    assert _stream(eng, world[1].cfg.vocab) == jax_stream


def test_jax_artifact_serves_port_tokens(world, tmp_path):
    jm, tm, params = world
    path = japi.compress(jm, jax.tree_util.tree_map(jnp.asarray, params)).save(
        tmp_path / "jax.edge.npz")
    assert tapi.load(path).arch_config == tm.cfg
    want = _stream(japi.load(path).engine(**ENGINE), tm.cfg.vocab)
    assert _stream(tapi.load(path).engine(device="cpu", **ENGINE), tm.cfg.vocab) == want


def test_static_path_matches_jax(port_path, world):
    """``generate(continuous=False)``: one batch prefill inside the ring
    (the longest prompt 40 > 32 is kept as its last 32 tokens), then 40
    lockstep decodes that wrap it."""
    kw = dict(quality="mid", continuous=False, batch_slots=4)
    prompts = _prompts(world[1].cfg.vocab)[:4]
    want = japi.load(port_path).engine(**kw).generate(prompts, max_new=40)
    got = tapi.load(port_path).engine(device="cpu", **kw).generate(prompts, max_new=40)
    assert got == want and all(len(t) == 40 for t in got)


def test_speculation_refused(port_path):
    """The ring cannot roll back rejected drafts: both engines refuse a
    speculating request at submit."""
    for mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
        eng = mod.load(port_path).engine(**ENGINE, **kw)
        with pytest.raises(mod.SubmitRejected, match="full-length KV cache"):
            eng.submit([1, 2, 3], max_new=4, speculate=mod.SpecConfig(draft_tier="lo", k=2))


def test_train_launcher_takes_the_arch():
    tr = ttrain.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "48",
                      "--grad-compression", "--device", "cpu"])
    assert len(tr.metrics_log) == 2 and all(np.isfinite(m["loss"]) for m in tr.metrics_log)
