"""The encoder-decoder family in the port (whisper-tiny), against the JAX package.

Everything runs at the whisper smoke config: 2 encoder and 2 decoder
layers, d 64, 4 heads, 32 encoder frames, f32.  Weights are drawn with
numpy (the token embeddings and the head at std 0.5, so the tokens, not
the sinusoids, decide the logits).  Tolerance: atol = rtol = 2e-4 in f32
(``TOL``), gradients within 2e-4 of each leaf's largest value.  The
forward's numpy sinusoid table is bit-equal to the JAX package's; the
decode's rows, computed on the device (``_sin_pos_at``), agree within 1e-6
at the smoke width.  At whisper-tiny's width (d 384) torch's f32 ``pow``
and XLA's differ by one ulp at one exponent (10000^(160/384)), and the
angle ``pos / 10000^(2i/d)`` carries that relative error, so the rows
there are held elementwise within 1e-6 + angle x 2^-23.

The engine's ``generate()`` builds its cache with zero cross K/V in both
packages, and cross attention over zero K/V is exactly 0: its tokens do
not depend on the audio.  Only the filled path (``encdec_prefill_cross``,
then ``Model.decode``) tests cross attention; planted faults there (the
encoder output fed unnormed, two layers' cross K/V swapped) must fail the
comparison.

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
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit

ARCH = "whisper_tiny"
TOL = dict(atol=2e-4, rtol=2e-4)
SIN_TOL = 1e-6
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, ted, tlayers, TModel, tinit, tserve, tstore
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch.launch import serve as tserve
        from repro_torch.models import encdec as ted
        from repro_torch.models import layers as tlayers
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.quant import store as tstore
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's (CONFIG, SMOKE_CONFIG) of whisper-tiny."""
    with jax_config_scope():
        return jget_arch(ARCH), jget_arch(ARCH, smoke=True)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _draw(descs, seed):
    """numpy leaves for a JAX descriptor tree: fan-in matmuls, the embedding
    and head at std 0.5, norm scales near 1."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init in ("ones", "zeros"):
            return (1.0 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": 0.5}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(leaf, descs)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def world(jcfgs):
    """Both smoke models, numpy params, and the JAX loss-with-grads (the
    forward's logits beside it) and decode step, each jitted once."""
    jm, tm = JModel(jcfgs[1]), TModel(tconfigs.get_arch(ARCH, smoke=True))
    params = _draw(jm.param_descs(), 0)

    def loss_logits(p, batch):
        logits, _ = jed.encdec_forward(p, jm.cfg, batch["frames"], batch["tokens"])
        return jlayers.next_token_loss(logits, batch["labels"]), logits

    fns = dict(grad=jax.jit(jax.value_and_grad(loss_logits, has_aux=True)),
               decode=jax.jit(jm.decode))
    return jm, tm, params, fns


def _desc_list(descs, jax_tree=False):
    """(shape, axes, init, dtype name) of every ParamDesc leaf, in tree order."""
    name = (lambda d: np.dtype(d).name) if jax_tree else (
        lambda d: str(d).removeprefix("torch."))
    return [(tuple(d.shape), tuple(d.axes), d.init, name(d.dtype))
            for d in jax.tree_util.tree_leaves(descs, is_leaf=lambda d: hasattr(d, "axes"))]


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
    full = tconfigs.get_arch(ARCH)
    assert (full.n_layers, full.enc_layers, full.enc_seq, full.d_model, full.n_heads,
            full.d_ff, full.vocab) == (4, 4, 1500, 384, 6, 1536, 51865)


def test_param_and_cache_descs_match_jax(world):
    jm, tm, _, _ = world
    assert _desc_list(tm.param_descs()) == _desc_list(jm.param_descs(), True)
    tc, jc = tm.cache_descs(3, 10), jm.cache_descs(3, 10)
    assert type(tc).__name__ == "EncDecCache" and tc._fields == jc._fields
    assert _desc_list(tc) == _desc_list(jc, True)
    assert tc.cross_k.shape == (2, 3, 32, 4, 16) and tc.kv.k.shape == (2, 3, 10, 4, 16)


def test_sinusoids_match_jax():
    """The forward's numpy table bit for bit at both configs' shapes; the
    decode's device rows at positions up to 1499 within ``SIN_TOL`` (d 64)
    and within ``SIN_TOL`` + angle x 2^-23 (d 384, one ulp of ``pow``)."""
    for s, d in ((32, 64), (1500, 384)):
        np.testing.assert_array_equal(tlayers.sinusoidal_pos_emb(s, d),
                                      jlayers.sinusoidal_pos_emb(s, d))
    pos = np.array([0, 1, 7, 31, 447, 1024, 1499], np.int32)
    for d in (64, 384):
        got = ted._sin_pos_at(_t(pos), d, torch.float32).numpy()
        want = np.asarray(jed._sin_pos_at(_j(pos), d, jnp.float32))
        ang = pos[:, None] / 10000.0 ** (2.0 * np.arange(d // 2) / d)
        tol = SIN_TOL + (0 if d == 64 else np.concatenate([ang, ang], 1) * 2.0 ** -23)
        assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


def test_forward_loss_and_grads_match_jax(world):
    """Logits, loss and every gradient against the JAX package (the
    encoder non-causal without RoPE, GELU's tanh form); ``encode`` alone
    too.  A planted fault, the encoder output fed on unnormed, must move the
    logits past the tolerance."""
    jm, tm, params, fns = world
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    frames = _frames(tm.cfg, 2, 2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (jloss, jlogits), jgrads = fns["grad"](
        jp, {"tokens": _j(toks), "labels": _j(labels), "frames": _j(frames)})
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), params)
    batch = {"tokens": _t(toks), "labels": _t(labels), "frames": _t(frames)}
    logits = tm.forward(tp, batch)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    tloss = tm.loss(tp, batch)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-4)
    for (path, g), t in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                            jax.tree_util.tree_leaves(tp), strict=True):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=2e-4, atol=2e-4 * np.abs(g).max(),
                                   err_msg=jax.tree_util.keystr(path))
    with torch.no_grad():
        enc = ted.encode(tp, tm.cfg, _t(frames))
        np.testing.assert_allclose(enc.numpy(), np.asarray(jed.encode(jp, jm.cfg, _j(frames))),
                                   **TOL)
        unnormed = dict(tp, enc_norm=None)
        orig = tlayers.rmsnorm
        tlayers.rmsnorm = lambda x, s, eps=1e-6: x if s is None else orig(x, s, eps)
        try:
            bad = tm.forward(unnormed, batch)
        finally:
            tlayers.rmsnorm = orig
    gap = float((bad - logits.detach()).abs().max())
    assert gap > 100 * TOL["atol"], f"the unnormed encoder moves the logits only {gap:.2e}"


def _filled(model, params, frames, b, t, jax_side):
    """A decode cache of (b, t) with the cross K/V of ``frames`` filled."""
    if jax_side:
        c = jinit(jax.random.PRNGKey(0), model.cache_descs(b, t))
        ck, cv = jed.encdec_prefill_cross(params, model.cfg, _j(frames))
        return jed.EncDecCache(kv=c.kv, cross_k=ck, cross_v=cv)
    c = tinit(model.cache_descs(b, t), device="cpu")
    ck, cv = ted.encdec_prefill_cross(params, model.cfg, _t(frames))
    return ted.EncDecCache(kv=c.kv, cross_k=ck, cross_v=cv)


def test_filled_decode_matches_jax_and_forward(world):
    """``encdec_prefill_cross`` against JAX's; step-by-step decode over the
    filled cache against the JAX decode (logits and every cache leaf) and
    against the port's forward; the two decoder layers' cross K/V swapped
    must move the logits past the tolerance."""
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab, (3, 9)).astype(np.int32)
    frames = _frames(tm.cfg, 3, 4)
    jc, tc = _filled(jm, jp, frames, 3, 12, True), _filled(tm, tp, frames, 3, 12, False)
    np.testing.assert_allclose(tc.cross_k.numpy(), np.asarray(jc.cross_k), **TOL)
    np.testing.assert_allclose(tc.cross_v.numpy(), np.asarray(jc.cross_v), **TOL)
    swap = ted.EncDecCache(kv=type(tc.kv)(*(t.clone() for t in tc.kv)),
                           cross_k=tc.cross_k.flip(0), cross_v=tc.cross_v.flip(0))
    rows, bad = [], []
    for i in range(toks.shape[1]):
        step = {"tokens": _t(toks[:, i:i + 1])}
        jl, jc = fns["decode"](jp, jc, {"tokens": _j(toks[:, i:i + 1])})
        tl, tc = tm.decode(tp, tc, step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        rows.append(tl)
        bad.append(tm.decode(tp, swap, step)[0])
    for a, b in zip(jax.tree_util.tree_leaves(tuple(tc)), jax.tree_util.tree_leaves(jc),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.full((2, 3), 9))
    dec = torch.cat(rows, 1)
    fwd = tm.forward(tp, {"tokens": _t(toks), "frames": _t(frames)})
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **TOL)
    gap = float((torch.cat(bad, 1) - dec).abs().max())
    assert gap > 100 * TOL["atol"], f"swapped cross K/V move the logits only {gap:.2e}"


def test_scanned_prefill_matches_jax(world):
    """Left-padded prompts through the port's per-token scan (pads pass
    through, as in JAX) against the JAX decode step run over the prompt
    (JAX's scanned prefill is a ``lax.scan`` of it), on a zero cache."""
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(5)
    lens = np.array([8, 3, 5], np.int32)
    toks = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lens):
        toks[i, 8 - n:] = rng.integers(1, tm.cfg.vocab, n)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 12))
    for i in range(toks.shape[1]):
        jl, jc = fns["decode"](jp, jc, {"tokens": _j(toks[:, i:i + 1])})
    zero = tinit(tm.cache_descs(3, 12), device="cpu")
    tc, tl = tm.prefill(tp, zero, _t(toks), _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl[:, -1]), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(tc)), jax.tree_util.tree_leaves(jc),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(zero.kv.k.abs().max()) == 0 and int(zero.kv.pos.max()) == 0


@pytest.fixture(scope="module")
def artifacts(world, tmp_path_factory):
    """One artifact of the port's ``compress``, saved by the port and saved
    again by the JAX package, the prompts, and the JAX engine of each file
    (decoded at load: one compile serves every tier)."""
    _, tm, params, _ = world
    d = tmp_path_factory.mktemp("encdec")
    port = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"),
                         device="cpu").save(d / "port.edge.npz")
    paths = {"port": port, "jax": japi.load(port).save(d / "jax.edge.npz")}
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tm.cfg.vocab, size=int(n)).tolist() for n in (6, 2, 9)]
    engines = {k: japi.load(p).engine(quality="hi", batch_slots=4, packed=False)
               for k, p in paths.items()}
    return paths, prompts, engines


def test_packed_forward_matches_dense(artifacts):
    """``Model.forward`` on the packed served tree (its stacked leaves
    sliced with ``layer``; K3 on a card) equals the forward on the same
    tree decoded to dense."""
    paths, _, _ = artifacts
    art = tapi.load(paths["port"])
    tm = art.model()
    tp, n = art.serve_params("mid", device="cpu")
    assert n > 0
    toks = np.random.default_rng(11).integers(0, tm.cfg.vocab, (2, 7)).astype(np.int32)
    batch = {"tokens": _t(toks), "frames": _t(_frames(tm.cfg, 2, 12))}
    dense = tstore.dense_tree(tp, like=tm.param_descs())
    np.testing.assert_allclose(tm.forward(tp, batch).numpy(), tm.forward(dense, batch).numpy(),
                               **TOL)


@pytest.mark.parametrize("saver", ["port", "jax"])
@pytest.mark.parametrize("quality", ["hi", "mid", "lo"])
def test_static_greedy_tokens_match_jax(artifacts, saver, quality):
    """The port's packed single-tier engine gives the tokens of the JAX
    engine serving the same tier of the same artifact (zero cross K/V in
    both: cross attention adds 0 there)."""
    paths, prompts, engines = artifacts
    te = tapi.load(paths[saver]).engine(quality=quality, batch_slots=4, device="cpu")
    assert not te.per_request_quality and te.n_packed_leaves > 0
    got = te.generate(prompts, max_new=MAX_NEW)
    assert got == engines[saver].set_quality(quality).generate(prompts, max_new=MAX_NEW)
    assert all(len(t) == MAX_NEW for t in got) and len({tuple(t) for t in got}) > 1


def test_refusals_match_jax(world, artifacts):
    """Per-slot tiers in ``decode``, verify and lane admission refuse in both
    packages with the same messages; ``submit``, ``--stream`` and
    per-request tiers refuse, and ``generate`` serves on the static path."""
    jm, tm, params, _ = world
    paths, prompts, _ = artifacts
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    cache = tinit(tm.cache_descs(2, 8), device="cpu")
    jcache = jinit(jax.random.PRNGKey(0), jm.cache_descs(2, 8))
    tok = np.zeros((2, 1), np.int32)
    for m, p, c, a in ((tm, tp, cache, _t), (jm, jp, jcache, _j)):
        with pytest.raises(ValueError, match="only supported by attention families"):
            m.decode(p, c, {"tokens": a(tok), "tiers": a(tok[:, 0])})
        with pytest.raises(ValueError, match="speculative verify needs an attention family"):
            m.verify(p, c, {"tokens": a(tok), "start": a(tok[:, 0]), "wlen": a(tok[:, 0]),
                            "spec": a(tok[:, 0])})
        with pytest.raises(ValueError, match="single-slot cache admission"):
            m.cache_insert_slot(c, c, 0)
    art = tapi.load(paths["port"])
    eng = art.engine(quality="hi", batch_slots=4, device="cpu")
    with pytest.raises(ValueError, match=r"continuous batching needs an attention family"):
        eng.submit(prompts[0], max_new=2)
    with pytest.raises(ValueError, match="attention family"):
        art.engine(quality="hi", per_request=True, device="cpu")
    with pytest.raises(ValueError, match="attention famil"):
        tserve.main(["--arch", ARCH, "--wire", "--stream", "--device", "cpu"])


def test_launcher_serves_whisper(capsys):
    eng = tserve.main(["--arch", ARCH, "--wire", "--device", "cpu", "--max-new", "4"])
    assert eng.model.cfg.family == "encdec" and eng.n_packed_leaves > 0
    assert not eng.per_request_quality
    assert "tok/s" in capsys.readouterr().out
