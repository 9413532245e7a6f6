"""The VLM family in the port (llama-3.2-vision-11b), against the JAX package.

Everything runs at the llama-vision smoke config: 4 self-attention layers
in two groups of ``cross_every`` = 2, each group followed by a gated
cross-attention block over 16 vision tokens, d 64, f32.  Weights are drawn
with numpy; the cross blocks' ``gate``/``gate_mlp`` (zero at init, which
makes a cross block the identity) are spread to tanh values of 0.3-0.9 of
either sign, so every comparison sees the cross path.  Tolerance: atol =
rtol = 2e-4 in f32 (``TOL``), gradients within 2e-4 of each leaf's largest
value.

The engine's ``generate()`` builds its cache with zero cross K/V in both
packages, and cross attention over zero K/V is exactly 0: its tokens do
not depend on an image.  Only the filled path (``vision_prefill_cross_kv``
and then ``Model.decode``) tests cross attention; a planted fault there
(one cross block's K/V swapped with the other's, or zeroed) must fail the
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
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit

ARCH = "llama_3_2_vision_11b"
TOL = dict(atol=2e-4, rtol=2e-4)
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, tlayers, ttr, TModel, tinit, tserve, tstore
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch.launch import serve as tserve
        from repro_torch.models import layers as tlayers
        from repro_torch.models import transformer as ttr
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.quant import store as tstore
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's (CONFIG, SMOKE_CONFIG) of llama-3.2-vision-11b."""
    with jax_config_scope():
        return jget_arch(ARCH), jget_arch(ARCH, smoke=True)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _draw(descs, seed):
    """numpy leaves for a JAX descriptor tree: fan-in matmuls, gates of
    |tanh| 0.3-0.9 with either sign, norm scales near 1, a router of std 0.3
    (no near-ties in its top-k)."""
    rng = np.random.default_rng(seed)

    def leaf(path, d):
        name = jax.tree_util.keystr(path)
        if "gate" in name:
            return (rng.uniform(0.3, 1.5, d.shape) * rng.choice([-1.0, 1.0], d.shape)
                    ).astype(np.float32)
        if d.init in ("ones", "zeros"):
            return (1.0 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        std = 0.3 if "router" in name else {
            "fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, descs)


def _embeds(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _loss_fn(jm):
    """lm_loss's body with the forward's logits and aux loss kept (one forward)."""
    def loss(p, batch):
        logits, aux = jtr.lm_forward(p, jm.cfg, batch["tokens"], batch["vision_embeds"])
        return jlayers.next_token_loss(logits, batch["labels"]) + 0.01 * aux, (logits, aux)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def world(jcfgs):
    """Both smoke models, numpy params, and the JAX loss-with-grads and
    decode step, each jitted once."""
    jm, tm = JModel(jcfgs[1]), TModel(tconfigs.get_arch(ARCH, smoke=True))
    params = _draw(jm.param_descs(), 0)
    return jm, tm, params, dict(grad=_loss_fn(jm), decode=jax.jit(jm.decode))


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
    assert (full.n_layers, full.d_model, full.n_kv, full.d_ff, full.vocab, full.cross_every,
            full.vision_tokens, full.rope_theta) == (40, 4096, 8, 14336, 128256, 5, 1024, 5e5)


def test_param_and_cache_descs_match_jax(world):
    """The trees, shapes, axes, inits and dtypes of the parameters (the two
    cross blocks' gates (1,) f32 zeros) and of the cache (zero cross K/V of
    (n_cross, B, T_img, Kv, hd))."""
    jm, tm, _, _ = world
    assert _desc_list(tm.param_descs()) == _desc_list(jm.param_descs(), True)
    gate = tm.param_descs()["cross_blocks"]["gate"]
    assert (gate.shape, gate.init, gate.dtype) == ((2, 1), "zeros", torch.float32)
    tc, jc = tm.cache_descs(3, 10), jm.cache_descs(3, 10)
    assert tc._fields == jc._fields == ("kv", "cross_kv")
    assert _desc_list(tc) == _desc_list(jc, True)
    assert tc.cross_kv[0].shape == (2, 3, 16, 2, 16)
    dense = TModel(dataclasses.replace(tm.cfg, cross_every=0))
    assert dense.cache_descs(3, 10).cross_kv is None and "cross_blocks" not in dense.param_descs()


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_and_cross_kv_match_jax(qk_norm):
    """``cross_kv`` and ``cross_attention`` on one block's weights, with and
    without qk_norm, and ``attention(causal=False)`` without RoPE."""
    rng = np.random.default_rng(7)
    descs = jlayers.attn_descs(64, 4, 2, 16, qk_norm=qk_norm)
    p = _draw(descs, 3)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), tconvert.params_from_numpy(p, "cpu")
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 11, 64)).astype(np.float32)
    jkv = jlayers.cross_kv(jp, _j(enc))
    tkv = tlayers.cross_kv(tp, _t(enc))
    for a, b in zip(tkv, jkv, strict=True):
        assert tuple(a.shape) == (2, 11, 2, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    got = tlayers.cross_attention(tp, _t(x), tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.cross_attention(jp, _j(x), jkv)),
                               **TOL)
    swapped = tlayers.cross_attention(tp, _t(x), (tkv[0], tkv[1].flip(1)))
    assert float((swapped - got).abs().max()) > 1e-2, "a V permutation must move the output"
    full = tlayers.attention(tp, _t(x), positions=None, causal=False)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jlayers.attention(jp, _j(x), positions=None, causal=False)),
        **TOL)
    causal = tlayers.attention(tp, _t(x), positions=None)
    np.testing.assert_array_equal(causal[:, -1].numpy(), full[:, -1].numpy())
    assert float((causal[:, 0] - full[:, 0]).abs().max()) > 1e-3


def test_forward_loss_and_grads_match_jax(world):
    """Logits, loss and every gradient (the gates' included) against the
    JAX package; the same weights with the gates at zero give logits that
    do not depend on the image."""
    jm, tm, params, fns = world
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    emb = _embeds(tm.cfg, 2, 2)
    (jloss, (jlogits, _)), jgrads = fns["grad"](
        jax.tree_util.tree_map(jnp.asarray, params),
        {"tokens": _j(toks), "labels": _j(labels), "vision_embeds": _j(emb)})
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), params)
    batch = {"tokens": _t(toks), "labels": _t(labels), "vision_embeds": _t(emb)}
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
        shut = jax.tree_util.tree_map(lambda a: _t(a), params)
        for g in ("gate", "gate_mlp"):
            shut["cross_blocks"][g].zero_()
        a = tm.forward(shut, batch)
        b = tm.forward(shut, dict(batch, vision_embeds=_t(_embeds(tm.cfg, 2, 9))))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float((a - logits.detach()).abs().max()) > 1e-2


def test_moe_vlm_loss_and_grads_match_jax(jcfgs):
    """A VLM whose self-attention blocks are MoE (4 experts, top-2; 2 layers,
    a cross block after each): logits, the aux loss summed over layers /
    n_layers, the loss and gradients."""
    moe = dict(name="vlm-moe", n_layers=2, cross_every=1, vision_tokens=8)
    jm = JModel(dataclasses.replace(jcfgs[1], moe=JMoE(n_experts=4, top_k=2), **moe))
    tm = TModel(dataclasses.replace(tconfigs.get_arch(ARCH, smoke=True),
                                    moe=tconfigs.MoEConfig(n_experts=4, top_k=2), **moe))
    params = _draw(jm.param_descs(), 4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 10)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    emb = rng.standard_normal((2, 8, 64)).astype(np.float32)
    (jloss, (jlogits, jaux)), jgrads = _loss_fn(jm)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"tokens": _j(toks), "labels": _j(labels), "vision_embeds": _j(emb)})
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), params)
    batch = {"tokens": _t(toks), "labels": _t(labels), "vision_embeds": _t(emb)}
    logits, aux = ttr.lm_forward_aux(tp, tm.cfg, batch["tokens"], batch["vision_embeds"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    assert float(aux.detach()) > 0.5
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=2e-4)
    tloss = tm.loss(tp, batch)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-4)
    for (path, g), t in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                            jax.tree_util.tree_leaves(tp), strict=True):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


def _filled(model, params, emb, b, t, jax_side):
    """A decode cache of (b, t) with the cross K/V of ``emb`` filled."""
    if jax_side:
        c = jinit(jax.random.PRNGKey(0), model.cache_descs(b, t))
        return jtr.LMCache(kv=c.kv, cross_kv=jtr.vision_prefill_cross_kv(params, model.cfg,
                                                                         _j(emb)))
    c = tinit(model.cache_descs(b, t), device="cpu")
    return ttr.LMCache(kv=c.kv, cross_kv=ttr.vision_prefill_cross_kv(params, model.cfg, _t(emb)))


def _clone(kv):
    return type(kv)(*(t.clone() for t in kv))


def test_filled_decode_matches_jax_and_forward(world):
    """``vision_prefill_cross_kv`` against JAX's; then step-by-step decode
    over the filled cache against the JAX decode (logits and every cache
    leaf) and against the port's own forward on the same embeds.  Planted
    faults, one cross block's K/V swapped with the other's or zeroed, must
    move the logits past the tolerance."""
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (3, 9)).astype(np.int32)
    emb = _embeds(tm.cfg, 3, 3)
    jc, tc = _filled(jm, jp, emb, 3, 12, True), _filled(tm, tp, emb, 3, 12, False)
    assert tc.cross_kv[0].shape == (2, 3, 16, 2, 16)
    for a, b in zip(tc.cross_kv, jc.cross_kv, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    swap = ttr.LMCache(kv=_clone(tc.kv), cross_kv=tuple(t.flip(0) for t in tc.cross_kv))
    zero = ttr.LMCache(kv=_clone(tc.kv), cross_kv=tuple(
        torch.cat([t[:1], torch.zeros_like(t[1:])]) for t in tc.cross_kv))
    rows, bad = [], {"swap": [], "zero": []}
    for i in range(toks.shape[1]):
        step = {"tokens": _t(toks[:, i:i + 1])}
        jl, jc = fns["decode"](jp, jc, {"tokens": _j(toks[:, i:i + 1])})
        tl, tc = tm.decode(tp, tc, step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        rows.append(tl)
        bad["swap"].append(tm.decode(tp, swap, step)[0])
        bad["zero"].append(tm.decode(tp, zero, step)[0])
    for a, b in zip(jax.tree_util.tree_leaves(tuple(tc)), jax.tree_util.tree_leaves(jc),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    dec = torch.cat(rows, 1)
    fwd = tm.forward(tp, {"tokens": _t(toks), "vision_embeds": _t(emb)})
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **TOL)
    for name, r in bad.items():
        gap = float((torch.cat(r, 1) - dec).abs().max())
        assert gap > 100 * TOL["atol"], f"planted fault {name} moves the logits only {gap:.2e}"


@pytest.fixture(scope="module")
def artifacts(world, tmp_path_factory):
    """One artifact of the port's ``compress``, saved by the port and saved
    again by the JAX package, the prompts, and the JAX engine of each file
    (decoded at load: one compile serves every tier)."""
    _, tm, params, _ = world
    d = tmp_path_factory.mktemp("vlm")
    port = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"),
                         device="cpu").save(d / "port.edge.npz")
    paths = {"port": port, "jax": japi.load(port).save(d / "jax.edge.npz")}
    rng = np.random.default_rng(4)
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
    batch = {"tokens": _t(toks), "vision_embeds": _t(_embeds(tm.cfg, 2, 12))}
    dense = tstore.dense_tree(tp, like=tm.param_descs())
    np.testing.assert_allclose(tm.forward(tp, batch).numpy(), tm.forward(dense, batch).numpy(),
                               **TOL)


@pytest.mark.parametrize("saver", ["port", "jax"])
@pytest.mark.parametrize("quality", ["hi", "mid", "lo"])
def test_static_greedy_tokens_match_jax(artifacts, saver, quality):
    """The port's packed single-tier engine gives the tokens of the JAX
    engine serving the same tier of the same artifact (zero cross K/V in
    both: the cross blocks add 0 there)."""
    paths, prompts, engines = artifacts
    te = tapi.load(paths[saver]).engine(quality=quality, batch_slots=4, device="cpu")
    assert not te.per_request_quality and te.n_packed_leaves > 0
    got = te.generate(prompts, max_new=MAX_NEW)
    assert got == engines[saver].set_quality(quality).generate(prompts, max_new=MAX_NEW)
    assert all(len(t) == MAX_NEW for t in got)


def test_packed_decode_with_tiers_matches_jax(artifacts):
    """``Model.decode`` on the per-request packed tree with per-slot tiers
    and a demand floor (K2's plain version on the CPU) over a filled cache,
    against the JAX package on the same served tree; the cross blocks run
    at full planes in both."""
    paths, _, _ = artifacts
    jart, tart = japi.load(paths["port"]), tapi.load(paths["port"])
    jm, tm = jart.model(), tart.model()
    jp, _ = jart.serve_params("hi", per_request=True)
    tp, _ = tart.serve_params("hi", per_request=True, device="cpu")
    emb = _embeds(tm.cfg, 3, 5)
    jc, tc = _filled(jm, jp, emb, 3, 8, True), _filled(tm, tp, emb, 3, 8, False)
    tiers = np.array([2, 0, 1], np.int32)
    jdecode = jax.jit(lambda p, c, tok, t: jm.decode(p, c, {"tokens": tok, "tiers": t,
                                                             "demand": 0}))
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab, (3, 3)).astype(np.int32)
    for i in range(toks.shape[1]):
        jl, jc = jdecode(jp, jc, _j(toks[:, i:i + 1]), _j(tiers))
        tl, tc = tm.decode(tp, tc, {"tokens": _t(toks[:, i:i + 1]), "tiers": _t(tiers),
                                    "demand": 0})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    hi, _ = tm.decode(tp, _filled(tm, tp, emb, 3, 8, False),
                      {"tokens": _t(toks[:, :1]), "tiers": _t(np.zeros(3, np.int32))})
    lo, _ = tm.decode(tp, _filled(tm, tp, emb, 3, 8, False),
                      {"tokens": _t(toks[:, :1]), "tiers": _t(np.full(3, 2, np.int32))})
    assert float((hi - lo).abs().max()) > 1e-3, "the tiers must reach the self layers"


def test_refusals_match_jax(world, artifacts):
    """verify raises in ``lm_verify``, lane admission, ``submit``/``--stream``
    and per-request tiers refuse, each with the JAX package's message;
    ``generate`` serves on the static path."""
    jm, tm, params, _ = world
    paths, prompts, _ = artifacts
    tp = tconvert.params_from_numpy(params, "cpu")
    cache = tinit(tm.cache_descs(2, 8), device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    batch = {"tokens": tok, "start": tok[:, 0], "wlen": tok[:, 0], "spec": tok[:, 0]}
    jb = {k: _j(v.numpy()) for k, v in batch.items()}
    jcache = jinit(jax.random.PRNGKey(0), jm.cache_descs(2, 8))
    for fn, args in ((tm.verify, (tp, cache, batch)),
                     (jm.verify, (jax.tree_util.tree_map(jnp.asarray, params), jcache, jb))):
        with pytest.raises(ValueError, match="speculative verify requires an attention-only "
                                             "stack"):
            fn(*args)
    for m, c in ((tm, cache), (jm, jcache)):
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


def test_launcher_serves_the_vlm(capsys):
    eng = tserve.main(["--arch", ARCH, "--wire", "--device", "cpu", "--max-new", "4"])
    assert eng.model.cfg.family == "vlm" and eng.n_packed_leaves > 0
    assert not eng.per_request_quality
    assert "tok/s" in capsys.readouterr().out
