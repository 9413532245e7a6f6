"""The Jamba hybrid in the port (jamba-1.5-large-398b), against the JAX package.

Everything runs at the jamba smoke config: one block of 8 layers (one
attention layer, 7 Mamba2 mixers), an FFN after each, MoE (4 experts
top-2) at the odd sublayers and dense SwiGLU at the even ones, d 64,
SSD mixers of 4 heads of 32 in 2 groups of state 16, chunk 16, f32.
Weights are drawn with numpy, the mixers' decay rates, biases, skips and
conv taps and the router spread so that every term moves the output.
Tolerance: atol = rtol = 2e-4 in f32 everywhere (``TOL``), gradients
within 2e-4 of each leaf's largest value.  Greedy tokens from one shared
artifact are identical at every tier: the port's packed engine against
the JAX engine serving the same tier decoded at load.

The mamba, norm and FFN leaves of a block are stacked twice, (n_blocks,
period - 1 | n_dense | n_moe, ...): packed leaves keep both stack axes
through ``serve_tree``, ``to_plane_major`` and ``truncate``, and are
sliced twice with ``PackedWeight.layer`` as the JAX package slices them.

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
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.quant import store as jstore

ARCH = "jamba_1_5_large_398b"
TOL = dict(atol=2e-4, rtol=2e-4)
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconfigs, tconvert, thybrid, TModel, tinit, tserve, tstore
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch import configs as tconfigs
        from repro_torch import convert as tconvert
        from repro_torch.launch import serve as tserve
        from repro_torch.models import hybrid as thybrid
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.quant import store as tstore
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's (CONFIG, SMOKE_CONFIG) of jamba-1.5-large-398b."""
    with jax_config_scope():
        return jget_arch(ARCH), jget_arch(ARCH, smoke=True)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _draw(descs, seed):
    """numpy leaves for a descriptor tree (JAX ``ParamDesc`` leaves): fan-in
    matmuls, conv taps of std 0.3, a router of std 0.3 (no near-ties in its
    top-k), decay logs, dt biases and skips spread around their inits,
    norm scales near 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, d):
        name = jax.tree_util.keystr(path)
        if "a_log" in name or "dt_bias" in name:
            return rng.uniform(-1.0, 0.5, d.shape).astype(np.float32)
        if d.init in ("ones", "zeros"):
            return (1.0 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        if "conv" in name or "router" in name:
            std = 0.3
        else:
            std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, descs)


@pytest.fixture(scope="module")
def world(jcfgs):
    """Both smoke models, numpy params, and the two JAX functions, each
    jitted once: the loss with its gradients (its forward's logits and aux
    loss beside it) and the decode step, which the decode, the scanned
    prefill and the forward-vs-decode checks all reuse at one cache shape.
    Tracing the hybrid's graph dominates these compiles."""
    jm, tm = JModel(jcfgs[1]), TModel(tconfigs.get_arch(ARCH, smoke=True))
    params = _draw(jm.param_descs(), 0)

    def loss_logits(p, batch):
        # hybrid_loss's body, with the forward's outputs kept: one forward
        logits, aux = jhybrid.hybrid_forward(p, jm.cfg, batch["tokens"])
        return jlayers.next_token_loss(logits, batch["labels"]) + 0.01 * aux, (logits, aux)

    fns = dict(grad=jax.jit(jax.value_and_grad(loss_logits, has_aux=True)),
               decode=jax.jit(jm.decode))
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
            elif f.name in ("moe", "hybrid"):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
        assert t.sub_quadratic
    full = tconfigs.get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.moe.n_experts, full.ssm_groups) == \
        (72, 8192, 24576, 16, 8)


def _desc_list(descs):
    """(shape, axes, init) of every ParamDesc leaf, in tree order."""
    return [(tuple(d.shape), tuple(d.axes), d.init)
            for d in jax.tree_util.tree_leaves(descs, is_leaf=lambda d: hasattr(d, "axes"))]


def test_descs_and_ffn_rule_match_jax(world):
    """Parameter and cache descriptors (with and without a window) equal the
    JAX package's; sublayer i takes MoE iff i % moe_every == 1."""
    jm, tm, _, _ = world
    assert _desc_list(tm.param_descs()) == _desc_list(jm.param_descs())
    for window in (None, 6):
        jc = JModel(dataclasses.replace(jm.cfg, window=window)).cache_descs(3, 10)
        tc = TModel(dataclasses.replace(tm.cfg, window=window)).cache_descs(3, 10)
        assert type(tc).__name__ == "HybridCache" and tc._fields == jc._fields
        assert _desc_list(tc) == _desc_list(jc)
        assert tc.kv.k.shape[2] == (10 if window is None else 6)
    assert thybrid._ffn_counts(tm.cfg) == (4, 4)
    blocks = tm.param_descs()["blocks"]
    assert blocks["mamba"]["wz"].shape[:2] == (1, 7)
    assert blocks["dense_ffn"]["wg"].shape[:2] == blocks["moe_ffn"]["wg"].shape[:2] == (1, 4)


def test_forward_loss_and_grads_match_jax(world):
    jm, tm, params, fns = world
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 20)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    (jloss, (jlogits, jaux)), jgrads = fns["grad"](jax.tree_util.tree_map(jnp.asarray, params),
                                           {"tokens": _j(toks), "labels": _j(labels)})
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), params)
    batch = {"tokens": _t(toks), "labels": _t(labels)}
    logits, aux = thybrid.hybrid_forward(tp, tm.cfg, batch["tokens"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    assert float(aux) > 0.1, "the MoE layers' aux loss enters the loss"
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=2e-4)
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
    """Decode against the JAX decode (logits and every cache leaf), then the
    port's decode against its own forward at a dropless capacity factor
    (E / k: the forward routes the whole sequence at once, the decode one
    position at a time, so only dropless routing makes them one function)."""
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (3, 18)).astype(np.int32)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 24))
    tc = tinit(tm.cache_descs(3, 24), device="cpu")
    for i in range(toks.shape[1]):
        jl, jc = fns["decode"](jp, jc, {"tokens": _j(toks[:, i:i + 1])})
        tl, tc = tm.decode(tp, tc, {"tokens": _t(toks[:, i:i + 1])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_tree(tc, jc, **TOL)
    moe = tm.cfg.moe
    free = TModel(dataclasses.replace(tm.cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)))
    cache = tinit(free.cache_descs(3, 24), device="cpu")
    rows = []
    for i in range(toks.shape[1]):
        tl, cache = free.decode(tp, cache, {"tokens": _t(toks[:, i:i + 1])})
        rows.append(tl)
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(),
                               free.forward(tp, {"tokens": _t(toks)}).numpy(), **TOL)


def test_scanned_prefill_matches_jax(world):
    """Left-padded prompts through the port's per-token scan against the
    JAX package's scanned prefill, which is a ``lax.scan`` of this decode
    step (``make_cache_prefill_step``): run here as the jitted step over the
    prompt, at the decode check's cache shape."""
    jm, tm, params, fns = world
    tp = tconvert.params_from_numpy(params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    lens = np.array([8, 3, 5], np.int32)
    toks = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lens):
        toks[i, 8 - n:] = rng.integers(1, tm.cfg.vocab, n)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 24))
    for i in range(toks.shape[1]):
        jl, jc = fns["decode"](jp, jc, {"tokens": _j(toks[:, i:i + 1])})
    jl = jl[:, -1]
    zero = tinit(tm.cache_descs(3, 24), device="cpu")
    tc, tl = tm.prefill(tp, zero, _t(toks), _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_tree(tc, jc, **TOL)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.full((1, 3), 8))
    np.testing.assert_array_equal(tc.kv.pad.numpy(), 0)  # pads pass through, as in JAX
    assert float(zero.kv.k.abs().max()) == 0 and int(zero.kv.pos.max()) == 0


@pytest.fixture(scope="module")
def artifact(world, tmp_path_factory):
    """One artifact of the port's ``compress``, the prompts, and one JAX
    engine serving it dense (decoded at load, one tier at a time): its jitted
    steps compile once for every tier, where packed leaves' plane counts
    would make each tier a new compile of the hybrid's graph.  The JAX
    package's packed path is held in ``test_torch_ssm.py``."""
    _, tm, params, _ = world
    art = tapi.compress(tm, tconvert.params_from_numpy(params, "cpu"), device="cpu")
    path = art.save(tmp_path_factory.mktemp("hybrid") / "jamba.edge.npz")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, size=int(n)).tolist() for n in (6, 2, 9)]
    return path, prompts, japi.load(path).engine(quality="hi", batch_slots=4, packed=False)


@pytest.mark.parametrize("quality", ["hi", "mid", "lo"])
def test_static_greedy_tokens_match_jax(artifact, quality):
    """The port's packed single-tier engine gives the tokens of the JAX
    engine serving the same tier of the same artifact."""
    path, prompts, je = artifact
    te = tapi.load(path).engine(quality=quality, batch_slots=4, device="cpu")
    assert not te.per_request_quality and te.n_packed_leaves > 0
    got = te.generate(prompts, max_new=MAX_NEW)
    assert got == je.set_quality(quality).generate(prompts, max_new=MAX_NEW)
    assert all(len(t) == MAX_NEW for t in got)


def test_twice_stacked_packed_leaves(artifact):
    """``serve_tree`` keeps both stack axes of the mixers' and dense FFNs'
    packed leaves; ``to_plane_major`` and ``truncate`` keep them; sliced
    twice with ``layer`` each equals the JAX package's slice, bit for bit
    (the JAX ``serve_tree`` run on those leaves alone: a mixer's and a dense
    FFN's), and decodes as the stacked leaf's own slice."""
    path, _, je = artifact
    art = tapi.load(path)
    tp, n = art.serve_params("mid", device="cpu")
    assert n == tapi.load(path).engine(quality="mid", device="cpu").n_packed_leaves
    names = (("mamba", "wz", 7), ("dense_ffn", "wd", 4))
    jart = je.artifact
    wire = {"blocks": {g: {k: jart.wire["blocks"][g][k] for grp, k, _ in names if grp == g}
                       for g, _, _ in names}}
    descs = jart.model().param_descs()
    sub = {"blocks": {g: {k: descs["blocks"][g][k] for k in wire["blocks"][g]}
                      for g in wire["blocks"]}}
    jp, jn = jstore.serve_tree(jstore.tree_from_wire(wire), sub, drop_map=jart.drop_map("mid"))
    assert jn == len(names)
    blocks, jblocks = tp["blocks"], jp["blocks"]
    for group, name, inner in names:
        leaf, jleaf = blocks[group][name], jblocks[group][name]
        assert isinstance(leaf, tstore.PackedWeight) and leaf.plane_major
        assert leaf.planes.shape[:3] == (1, inner, 3) and leaf._stack() == 2
        assert leaf.to_plane_major() is leaf and leaf.n_planes == jleaf.n_planes
        np.testing.assert_array_equal(leaf.planes.numpy(), np.asarray(jleaf.planes))
        cut = leaf.truncate(1)
        assert cut.planes.shape == leaf.planes.shape and cut._stack() == 2
        np.testing.assert_array_equal(cut.planes.numpy(), np.asarray(jleaf.truncate(1).planes))
        dense = leaf.as_dense()
        for j in (0, inner - 1):
            one = leaf.layer(0).layer(j)
            assert one._stack() == 0 and one.shape == tuple(jleaf.shape[2:])
            np.testing.assert_array_equal(one.planes.numpy(), np.asarray(jleaf.planes)[0, j])
            np.testing.assert_array_equal(one.scales.numpy(), np.asarray(jleaf.scales)[0, j])
            np.testing.assert_array_equal(one.as_dense().numpy(), dense[0, j].numpy())
    assert isinstance(blocks["moe_ffn"]["wg"], torch.Tensor)  # experts serve dense
    assert isinstance(blocks["attn"]["wq"], tstore.PackedWeight)


def test_continuous_paths_refuse(world, artifact):
    _, tm, params, _ = world
    path, prompts, _ = artifact
    art = tapi.load(path)
    eng = art.engine(quality="hi", batch_slots=4, device="cpu")
    with pytest.raises(ValueError, match="attention famil"):
        eng.submit(prompts[0], max_new=2)
    with pytest.raises(ValueError, match="attention family"):
        art.engine(quality="hi", per_request=True, device="cpu")
    tp = tconvert.params_from_numpy(params, "cpu")
    cache = tinit(tm.cache_descs(2, 8), device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="speculative verify needs an attention family"):
        tm.verify(tp, cache, {"tokens": tok, "start": tok[:, 0], "wlen": tok[:, 0],
                              "spec": tok[:, 0]})
    with pytest.raises(ValueError, match="single-slot cache admission"):
        tm.cache_insert_slot(cache, tinit(tm.cache_descs(1, 8), device="cpu"), 0)
    with pytest.raises(ValueError, match="only supported by attention families"):
        tm.decode(tp, cache, {"tokens": tok, "tiers": torch.zeros((2,), dtype=torch.int32)})


def test_launcher_serves_the_hybrid(capsys):
    eng = tserve.main(["--arch", ARCH, "--wire", "--device", "cpu", "--max-new", "4"])
    assert eng.model.cfg.family == "hybrid" and eng.n_packed_leaves > 0
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="attention famil"):
        tserve.main(["--arch", ARCH, "--wire", "--stream", "--device", "cpu"])
