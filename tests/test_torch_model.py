"""The port's dense decoder against the JAX ``Model``.

* ``params_from_numpy`` carries a JAX parameter tree across and back.
* Prefill of left-padded prompts and N decode steps, per tier and on a
  mixed-tier batch, run on the same served tree in both packages (one
  artifact npz): logits agree within atol = rtol = 1e-4 in f32, and so do
  the KV caches after prefill and after every step (per-slot ``pos`` and
  ``pad`` exactly).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import api as japi
from repro.configs.base import ArchConfig as JArch
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.train.step import make_cache_prefill_step as jprefill_step

CFG = dict(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)
TOL = dict(atol=1e-4, rtol=1e-4)
N_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, TArch, params_from_numpy, params_to_numpy, TModel, tinit, is_desc, tree_map
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.configs.base import ArchConfig as TArch
        from repro_torch.convert import params_from_numpy, params_to_numpy
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import init_params as tinit
        from repro_torch.models.base import is_desc
        from repro_torch.tree import tree_map
        yield


def numpy_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    descs = TModel(TArch(**CFG, dtype=torch.float32)).param_descs()

    def draw(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return tree_map(draw, descs, is_leaf=is_desc)


def test_params_from_numpy_roundtrip():
    jm = JModel(JArch(**CFG, dtype=jnp.float32))
    jp = jinit(jax.random.PRNGKey(0), jm.param_descs())
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    back = params_to_numpy(tp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == 12
    for path, leaf in jflat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_params_from_numpy_bfloat16_bit_exact():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 5)), dtype=jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, dtype=np.float32))


def test_init_params_uses_generator_and_desc_kinds():
    descs = TModel(TArch(**CFG, dtype=torch.float32)).param_descs()
    a = tinit(descs, torch.Generator().manual_seed(3), device="cpu")
    b = tinit(descs, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["blocks"]["mlp"]["wg"], b["blocks"]["mlp"]["wg"])
    assert torch.equal(a["final_norm"], torch.ones(64))
    std = float(a["blocks"]["mlp"]["wg"].std())
    assert abs(std - 1 / np.sqrt(64)) < 0.02


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' per-request served trees from one port-written npz."""
    model = TModel(TArch(**CFG, dtype=torch.float32))
    art = tapi.compress(model, params_from_numpy(numpy_params(2), device="cpu"),
                        device="cpu")
    path = art.save(tmp_path_factory.mktemp("model_art") / "model.edge.npz")
    jm = JModel(JArch(**CFG, dtype=jnp.float32))
    jparams, _ = japi.load(path).serve_params("hi", per_request=True)
    tparams, _ = tapi.load(path).serve_params("hi", per_request=True, device="cpu")
    jprefill = jax.jit(jprefill_step(jm), static_argnums=(5,))
    jdecode = jax.jit(lambda p, c, tok, act, tiers, demand: jm.decode(
        p, c, {"tokens": tok, "active": act, "tiers": tiers, "demand": demand}),
        static_argnums=(5,))
    return jm, jparams, jprefill, jdecode, model, tparams


def _assert_cache_close(jc, tc):
    np.testing.assert_allclose(tc.kv.k.numpy(), np.asarray(jc.kv.k), **TOL)
    np.testing.assert_allclose(tc.kv.v.numpy(), np.asarray(jc.kv.v), **TOL)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))
    np.testing.assert_array_equal(tc.kv.pad.numpy(), np.asarray(jc.kv.pad))


@pytest.mark.parametrize("tiers", [(0, 0, 0), (1, 1, 1), (2, 2, 2), (2, 0, 1)])
def test_prefill_and_decode_match_jax(served, tiers):
    jm, jparams, jprefill, jdecode, tm, tparams = served
    rng = np.random.default_rng(sum(tiers))
    b, s, t = 3, 8, 16
    lens = np.array([8, 3, 5], np.int32)
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(0, CFG["vocab"], size=n)
    tier_arr = np.array(tiers, np.int32)
    demand = int(tier_arr.min())

    jcache = jinit(jax.random.PRNGKey(0), jm.cache_descs(b, t))
    jcache, jlog = jprefill(jparams, jcache, jnp.asarray(toks), jnp.asarray(lens),
                            jnp.asarray(tier_arr), demand)
    tcache = tinit(tm.cache_descs(b, t), device="cpu")
    tcache, tlog = tm.prefill(tparams, tcache, torch.from_numpy(toks),
                              torch.from_numpy(lens), torch.from_numpy(tier_arr), demand)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_cache_close(jcache, tcache)

    cur = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
    active = np.array([1, 1, 0], np.int32)  # a dead lane must hold its pos
    for _ in range(N_STEPS):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(cur), jnp.asarray(active),
                             jnp.asarray(tier_arr), demand)
        tl, tcache = tm.decode(tparams, tcache, {
            "tokens": torch.from_numpy(cur), "active": torch.from_numpy(active),
            "tiers": torch.from_numpy(tier_arr), "demand": demand})
        assert tl.shape == (b, 1, CFG["vocab"]) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(jcache, tcache)
        cur = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]


def test_windowed_config_raises():
    """A windowed config prefills a ring shorter than its left-padded prompt
    (the last t tokens at slots ``i % t``) into the JAX package's cache,
    logits within TOL; the one raise left for a windowed config is
    ``verify``, which needs a full-length KV cache, as in the JAX package."""
    cfg = dict(CFG, name="swa")
    jm = JModel(JArch(**cfg, window=8, dtype=jnp.float32))
    m = TModel(TArch(**cfg, window=8, dtype=torch.float32))
    params = numpy_params(5)
    tp = params_from_numpy(params, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(5).integers(0, CFG["vocab"], (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    toks[1, :12 - 7] = 0
    jc, jl = jm.prefill(jp, jinit(jax.random.PRNGKey(0), jm.cache_descs(2, 16)),
                        jnp.asarray(toks), jnp.asarray(lens))
    tc, tl = m.prefill(tp, tinit(m.cache_descs(2, 16), device="cpu"), torch.from_numpy(toks),
                       torch.from_numpy(lens))
    assert tc.kv.k.shape[2] == 8  # (L, B, T, Kv, hd): the ring holds the window
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(jc, tc)
    batch = {"tokens": torch.zeros((2, 2), dtype=torch.int32),
             "start": torch.full((2,), 12, dtype=torch.int32),
             "wlen": torch.full((2,), 2, dtype=torch.int32),
             "spec": torch.ones((2,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="full-length KV cache"):
        m.verify(tp, tc, batch)


@pytest.mark.parametrize("family", ["moe", "ssm", "vlm"])
def test_other_families_name_their_roadmap_item(family):
    """The families that once named their ROADMAP item now construct, and
    their forward equals the JAX package's at a tiny config (atol = rtol =
    1e-4, weights drawn with numpy, the cross gates nonzero): ``moe`` is a
    vlm stack that carries MoE layers, ``ssm`` the encoder-decoder, ``vlm``
    the vision LM itself."""
    from repro.configs.base import MoEConfig as JMoE
    from repro_torch.configs.base import MoEConfig

    extra, jextra = {}, {}
    if family == "moe":
        family = "vlm"
        extra, jextra = (dict(moe=m(n_experts=4, top_k=2), cross_every=1, vision_tokens=8)
                         for m in (MoEConfig, JMoE))
    elif family == "ssm":
        family = "encdec"
        extra = jextra = dict(enc_layers=2, enc_seq=16)
    else:
        extra = jextra = dict(cross_every=1, vision_tokens=8)
    tm = TModel(TArch(**{**CFG, "family": family}, **extra, dtype=torch.float32))
    jm = JModel(JArch(**{**CFG, "family": family}, **jextra, dtype=jnp.float32))
    rng = np.random.default_rng(11)

    def draw(path, d):
        if "gate" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.0, d.shape).astype(np.float32)
        if d.init in ("ones", "zeros"):
            return np.ones(d.shape, np.float32)
        std = 0.3 if d.init == "small" else {
            "fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, jm.param_descs())
    side = "vision_embeds" if family == "vlm" else "frames"
    batch = {"tokens": rng.integers(0, CFG["vocab"], (2, 6)).astype(np.int32),
             side: rng.standard_normal((2, 8 if family == "vlm" else 16, 64)).astype(np.float32)}
    want = jm.forward(jax.tree_util.tree_map(jnp.asarray, params),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.forward(params_from_numpy(params, device="cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 6, CFG["vocab"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
