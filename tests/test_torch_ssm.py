"""The Mamba2 SSD mixer and the mamba2 LM in the port, against the JAX package.

The mixer's pieces run on numpy inputs from a seed (d 64, d_inner 128, 8
heads of 16, 2 groups of state 16, chunk 16, f32); the model paths at the
mamba2 smoke config (2 layers, d 64, f32) on weights drawn with numpy,
the decay rates, biases, skips, norms and conv taps spread so that every
term of the mixer moves the output.  Tolerance: atol = rtol = 2e-4 in f32
everywhere (``TOL``), with gradients held within 2e-4 of each leaf's
largest value; the JAX package's own decode-vs-forward check uses 5e-2,
and the port sits far tighter against it.  Greedy tokens from one shared
artifact are identical at every tier.

Recurrent families serve one tier per engine through ``generate()``'s
static path (a per-token scanned prefill, then one decode loop) and refuse
``submit``, ``verify``, lane admission and per-slot tiers, with the JAX
package's errors.

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
from repro.models import ssm as jssm
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit

ARCH = "mamba2_1_3b"
TOL = dict(atol=2e-4, rtol=2e-4)
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, tssm, TModel, tinit, tserve, tstep
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch.launch import serve as tserve
        from repro_torch.models import ssm as tssm
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.train import step as tstep
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's (CONFIG, SMOKE_CONFIG) of mamba2-1.3b."""
    with jax_config_scope():
        return jget_arch(ARCH), jget_arch(ARCH, smoke=True)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _draw(descs, seed):
    """numpy leaves for a descriptor tree (JAX ``ParamDesc`` leaves): fan-in
    matmuls, conv taps of std 0.3, decay logs, dt biases and skips spread
    around their inits, norm scales near 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, d):
        name = jax.tree_util.keystr(path)
        if "a_log" in name or "dt_bias" in name:
            return rng.uniform(-1.0, 0.5, d.shape).astype(np.float32)
        if d.init in ("ones", "zeros"):
            return (1.0 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": 0.3 if "conv" in name
               else d.scale * 0.02, "small": d.scale * 0.006}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, descs)


@pytest.fixture(scope="module")
def world(jcfgs):
    """Both smoke models, numpy params, and the JAX functions jitted once."""
    jm, tm = JModel(jcfgs[1]), TModel(tconfigs.get_arch(ARCH, smoke=True))
    params = _draw(jm.param_descs(), 0)

    def loss_logits(p, batch):
        return jm.loss(p, batch), jm.forward(p, batch)

    fns = dict(grad=jax.jit(jax.value_and_grad(loss_logits, has_aux=True)),
               decode=jax.jit(jm.decode), prefill=jax.jit(jm.prefill))
    return jm, tm, params, fns


def _close_tree(got, want, **tol):
    """A port tree (NamedTuples of tensors) against a JAX one, leaf by leaf."""
    w = jax.tree_util.tree_leaves(want)
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                                         tuple(got)))
    assert len(g) == len(w)
    for a, b in zip(g, w, strict=True):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_configs_equal_jax(jcfgs):
    assert ARCH in tconfigs.ARCH_IDS
    for j, smoke in zip(jcfgs, (False, True), strict=True):
        t = tconfigs.get_arch(ARCH, smoke)
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name == "dtype":
                assert str(a).removeprefix("torch.") == np.dtype(b).name
            else:
                assert a == b, f.name
        assert t.sub_quadratic and t.hd == j.hd
    full = tconfigs.get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.vocab, full.ssm_state, full.ssm_head_dim) == \
        (48, 2048, 50280, 128, 64)


# --------------------------------------------------------------------------
# The mixer's pieces
# --------------------------------------------------------------------------
C = dict(d_model=64, d_inner=128, n_heads=8, head_dim=16, state=16, n_groups=2, chunk=16)


def test_causal_conv_and_segsum_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 24))).astype(np.float32)
    np.testing.assert_allclose(tssm._causal_conv(_t(x), _t(w)).numpy(),
                               np.asarray(jssm._causal_conv(_j(x), _j(w))), **TOL)
    dlog = -rng.uniform(0, 1, (2, 3, 16, 8)).astype(np.float32)
    got, want = tssm._segsum(_t(dlog)).numpy(), np.asarray(jssm._segsum(_j(dlog)))
    assert got.shape == want.shape == (2, 3, 8, 16, 16)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    xs = (30 * rng.standard_normal(64)).astype(np.float32)  # beyond F.softplus's cut at 20
    np.testing.assert_allclose(tssm.softplus(_t(xs)).numpy(),
                               np.asarray(jax.nn.softplus(_j(xs))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [12, 16, 40], ids=["partial", "exact", "multiple"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_chunked_matches_jax(s, with_h0):
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, C["n_heads"], C["head_dim"], C["n_groups"], C["state"]
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.2, 2.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if with_h0 else None
    jy, jh = jssm.ssd_chunked(_j(x), _j(dt), _j(a), _j(bm), _j(cm), 16,
                              None if h0 is None else _j(h0))
    ty, th = tssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), 16,
                              None if h0 is None else _t(h0))
    assert ty.shape == (b, s, h, p) and th.shape == (b, h, n, p)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def _mixer(seed):
    jc = jssm.SSMConfig(**C)
    p = _draw(jssm.ssm_descs(jc), seed)
    return jc, tssm.SSMConfig(**C), p


def test_ssm_forward_matches_jax():
    jc, tc, p = _mixer(2)
    x = np.random.default_rng(3).standard_normal((2, 40, 64)).astype(np.float32)
    want = jssm.ssm_forward({k: _j(v) for k, v in p.items()}, _j(x), jc)
    got = tssm.ssm_forward({k: _t(v) for k, v in p.items()}, _t(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_decode_and_state_match_jax_and_forward():
    """Decode step by step, the state written in place, against the JAX
    decode (output and every state leaf) and against the port's forward."""
    jc, tc, p = _mixer(4)
    x = np.random.default_rng(5).standard_normal((2, 20, 64)).astype(np.float32)
    jp, tp = {k: _j(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    jst = jinit(jax.random.PRNGKey(0), jssm.ssm_state_descs(jc, 2))
    tst = tinit(tssm.ssm_state_descs(tc, 2), device="cpu")
    assert tssm.SSMState._fields == jssm.SSMState._fields
    outs = []
    for i in range(x.shape[1]):
        jo, jst = jssm.ssm_decode(jp, _j(x[:, i:i + 1]), jst, jc)
        to, back = tssm.ssm_decode(tp, _t(x[:, i:i + 1]), tst, tc)
        assert back is tst
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _close_tree(tst, jst, **TOL)
        outs.append(to)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               tssm.ssm_forward(tp, _t(x), tc).numpy(), **TOL)


# --------------------------------------------------------------------------
# The model paths at the smoke config
# --------------------------------------------------------------------------
def test_forward_loss_and_grads_match_jax(world):
    jm, tm, params, fns = world
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 24)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    (jloss, jlogits), jgrads = fns["grad"](jax.tree_util.tree_map(jnp.asarray, params),
                                           {"tokens": _j(toks), "labels": _j(labels)})
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), params)
    batch = {"tokens": _t(toks), "labels": _t(labels)}
    np.testing.assert_allclose(tm.forward(tp, batch).detach().numpy(), np.asarray(jlogits),
                               **TOL)
    tloss = tm.loss(tp, batch)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-4)
    for (path, g), t in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                            jax.tree_util.tree_leaves(tp), strict=True):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=2e-4, atol=2e-4 * np.abs(g).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_decode_step_by_step_matches_jax_and_forward(world):
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (3, 20)).astype(np.int32)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 32))
    tc = tinit(tm.cache_descs(3, 32), device="cpu")
    rows = []
    for i in range(toks.shape[1]):
        jl, jc = fns["decode"](jp, jc, {"tokens": _j(toks[:, i:i + 1])})
        tl, tc = tm.decode(tp, tc, {"tokens": _t(toks[:, i:i + 1])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        rows.append(tl)
    _close_tree(tc, jc, **TOL)
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(),
                               tm.forward(tp, {"tokens": _t(toks)}).numpy(), **TOL)


def test_scanned_prefill_matches_jax(world):
    """Left-padded prompts through the per-token scan: cache and last logits
    as JAX's; ``lengths`` changes nothing (pads pass through the state, in
    both packages), and the input cache is left untouched."""
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    lens = np.array([9, 4, 1], np.int32)
    toks = np.zeros((3, 9), np.int32)
    for i, n in enumerate(lens):
        toks[i, 9 - n:] = rng.integers(1, tm.cfg.vocab, n)
    assert not tstep.supports_fused_prefill(tm)
    jc, jl = fns["prefill"](jp, jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 16)),
                            _j(toks), _j(lens))
    zero = tinit(tm.cache_descs(3, 16), device="cpu")
    tc, tl = tm.prefill(tp, zero, _t(toks), _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_tree(tc, jc, **TOL)
    assert all(float(t.abs().max()) == 0 for t in zero.ssm)
    _, tl_full = tm.prefill(tp, zero, _t(toks))
    np.testing.assert_array_equal(tl_full.numpy(), tl.numpy())
    dec = tm.forward(tp, {"tokens": _t(toks)})[:, -1]
    np.testing.assert_allclose(tl.numpy(), dec.numpy(), **TOL)


@pytest.fixture(scope="module")
def artifact(world, tmp_path_factory):
    """One artifact of the port's ``compress``, the prompts, the JAX
    package's load of it, and its JAX engines by tier, built once by
    :func:`_jengine` and shared by the tests that serve or inspect them."""
    _, tm, params, _ = world
    art = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"), device="cpu")
    path = art.save(tmp_path_factory.mktemp("ssm") / "mamba.edge.npz")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, size=int(n)).tolist() for n in (7, 3, 11)]
    return path, prompts, japi.load(path), {}


def _jengine(artifact, quality):
    """The JAX engine of ``artifact`` serving ``quality`` (packed)."""
    _, _, jart, engines = artifact
    if quality not in engines:
        engines[quality] = jart.engine(quality=quality, batch_slots=4)
    return engines[quality]


@pytest.mark.parametrize("quality", ["hi", "mid", "lo"])
def test_static_greedy_tokens_match_jax(artifact, quality):
    path, prompts, _, _ = artifact
    je = _jengine(artifact, quality)
    te = tapi.load(path).engine(quality=quality, batch_slots=4, device="cpu")
    assert not te.per_request_quality and not je.per_request_quality
    assert te.n_packed_leaves == je.n_packed_leaves > 0
    got = te.generate(prompts, max_new=MAX_NEW)
    assert got == je.generate(prompts, max_new=MAX_NEW)
    assert all(len(t) == MAX_NEW for t in got)


def test_single_tier_engine_redials_in_place(artifact):
    """A recurrent artifact builds a single-tier, plane-truncated engine:
    ``set_quality`` re-resolves it in place and serves the lower tier's
    tokens; per-request quality is refused."""
    path, prompts, _, _ = artifact
    art = tapi.load(path)
    eng = art.engine(quality="hi", batch_slots=4, device="cpu")
    hi = eng.generate(prompts, max_new=MAX_NEW)
    assert eng.set_quality("lo") is eng and eng.quality == "lo"
    lo = art.engine(quality="lo", batch_slots=4, device="cpu").generate(prompts, max_new=MAX_NEW)
    assert eng.generate(prompts, max_new=MAX_NEW) == lo != hi
    with pytest.raises(ValueError, match="attention family"):
        art.engine(quality="hi", per_request=True, device="cpu")
    with pytest.raises(ValueError, match="per-request qualities"):
        eng.generate(prompts, max_new=2, qualities="hi")
    hot = art.engine(quality="hi", temperature=0.8, batch_slots=4, device="cpu")
    assert hot.generate(prompts, max_new=4, seed=3) == hot.generate(prompts, max_new=4, seed=3)


def test_continuous_paths_refuse(world, artifact):
    jm, tm, params, _ = world
    path, prompts, _, _ = artifact
    eng = tapi.load(path).engine(quality="hi", batch_slots=4, device="cpu")
    with pytest.raises(ValueError, match="attention famil"):
        eng.submit(prompts[0], max_new=2)
    tp = tconvert.params_from_numpy(params, "cpu")
    cache = tinit(tm.cache_descs(2, 8), device="cpu")
    one = tinit(tm.cache_descs(1, 8), device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="speculative verify needs an attention family"):
        tm.verify(tp, cache, {"tokens": tok, "start": tok[:, 0], "wlen": tok[:, 0],
                              "spec": tok[:, 0]})
    with pytest.raises(ValueError, match="single-slot cache admission"):
        tm.cache_insert_slot(cache, one, 0)
    for key in ("active", "tiers", "demand"):
        val = 0 if key == "demand" else torch.ones((2,), dtype=torch.int32)
        with pytest.raises(ValueError, match="only supported by attention families"):
            tm.decode(tp, cache, {"tokens": tok, key: val})
    with pytest.raises(ValueError, match="one tier per engine"):
        tm.prefill(tp, cache, tok, tiers=torch.zeros((2,), dtype=torch.int32))


def test_serve_tree_packs_the_mixer(world, artifact):
    """The mixer's projections serve as packed stacked leaves; ``W`` decodes
    each layer's as the JAX package does, from the same artifact."""
    path, _, _, _ = artifact
    tp, n = tapi.load(path).serve_params("mid", device="cpu")
    je = _jengine(artifact, "mid")  # its params are the JAX serve_params("mid")
    jp, jn = je.params, je.n_packed_leaves
    assert n == jn
    mixer = tp["blocks"]["mixer"]
    for name in ("wz", "wx", "wB", "wC", "wdt", "wo"):
        leaf, jleaf = mixer[name], jp["blocks"]["mixer"][name]
        assert type(leaf).__name__ == "PackedWeight" and leaf.plane_major, name
        assert leaf.n_planes == jleaf.n_planes
        np.testing.assert_array_equal(leaf.planes.numpy(), np.asarray(jleaf.planes))
        np.testing.assert_array_equal(leaf.scales.numpy(), np.asarray(jleaf.scales))
    for i in range(2):
        want = jax.tree_util.tree_map(lambda a, i=i: a[i], jp["blocks"]["mixer"]["wz"])
        np.testing.assert_array_equal(mixer["wz"].layer(i).as_dense().numpy(),
                                      np.asarray(want.as_dense()))
    for name in ("conv_x", "a_log", "D", "dt_bias", "norm"):
        assert isinstance(mixer[name], torch.Tensor), name


def test_launcher_serves_and_refuses(capsys):
    eng = tserve.main(["--arch", ARCH, "--wire", "--quality", "mid", "--device", "cpu"])
    assert eng.model.cfg.family == "ssm" and eng.n_packed_leaves > 0
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="attention famil"):
        tserve.main(["--arch", ARCH, "--wire", "--stream", "--device", "cpu"])
    for extra in (["--mixed-tiers"], ["--speculate", "lo:2"]):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", ARCH, "--wire", "--stream", *extra, "--device", "cpu"])
        assert "attention family" in capsys.readouterr().err
