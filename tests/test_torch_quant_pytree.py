"""Whole-tree QSQ in the port against the JAX package: ``quant/pytree.py``,
``quant/packed.py`` and the public API gaps of this slice.

Both packages get the same parameters, made with numpy from a seed.

* ``quantize_pytree`` of LeNet (the conv view of Fig. 5 and the fcs):
  codes equal except at nearest-level ties (at most 1 in 10^4), scales
  within rtol 1e-6 (an f32 sum of |w| in another order);
  ``pytree_bits_report`` equal exactly; wire written by either package
  loads in the other losslessly (codes and scales bit for bit).
* ``pack_params`` (interleaved Table II planes, stacked layers): planes bit
  for bit where the codes are equal, i.e. everywhere outside counted ties;
  ``packed_param_descs`` shapes and ``packed_bits_report`` equal.
* Prefill and decode of the d64 config from a ``pack_params`` tree: logits
  within atol = rtol = 1e-4 of JAX's (f32 matmuls in two libraries) and
  the same greedy tokens.
* ``ServeEngine.from_wire`` on a trained smoke model (the counterpart of
  ``test_system.py::test_e2e_train_quantize_transfer_serve``) serves the
  JAX engine's tokens from the same wire.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import quant as jquant
from repro.configs.base import ArchConfig as JArch
from repro.core.policy import QuantPolicy as JPolicy
from repro.core.qsq import QSQConfig as JQSQConfig
from repro.models import cnn as jcnn
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.quant import packed as jpacked
from repro.quant.artifact import QualityTier as JTier
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine

CFG = dict(name="smollm-like", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)
PACK = dict(group_size=16, min_numel=1024)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tconvert, tquant, tpacked, tpolicy, tqsq, tArch, tModel, tinit, ttree, \
        tengine, tdata, ttrainer, toptim
    with port_modules():
        import repro_torch.api as tapi
        import repro_torch.convert as tconvert
        import repro_torch.core.policy as tpolicy
        import repro_torch.core.qsq as tqsq
        import repro_torch.data.pipeline as tdata
        import repro_torch.optim as toptim
        import repro_torch.quant as tquant
        import repro_torch.quant.packed as tpacked
        import repro_torch.serve.engine as tengine
        import repro_torch.train.trainer as ttrainer
        import repro_torch.tree as ttree
        from repro_torch.configs.base import ArchConfig as tArch
        from repro_torch.models.api import Model as tModel
        from repro_torch.models.base import init_params as tinit
        yield


def _lenet_params(seed=0):
    params = jinit(jax.random.PRNGKey(seed), jcnn.cnn_descs(jcnn.LENET))
    return jax.tree_util.tree_map(np.asarray, params)


def _policies(phi=4):
    kw = dict(phi=phi, group_size=16, refit_alpha=True)
    return (JPolicy(base=JQSQConfig(**kw), min_numel=256),
            tpolicy.QuantPolicy(base=tqsq.QSQConfig(**kw), min_numel=256))


def _is_q(x):
    return hasattr(x, "levels") and hasattr(x, "scales")


def _pairs(jtree, ttree_):
    """(JAX QSQ leaf, port QSQ leaf) in tree order."""
    jl = jax.tree_util.tree_leaves(jtree, is_leaf=_is_q)
    tl = ttree.tree_leaves(ttree_, is_leaf=tquant.is_store)
    assert len(jl) == len(tl)
    return [(a, b) for a, b in zip(jl, tl) if _is_q(a)]


@pytest.mark.parametrize("phi", [1, 2, 4])
def test_quantize_pytree_matches_jax(phi):
    params = _lenet_params()
    jpol, tpol = _policies(phi)
    jq = jquant.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, params), jpol)
    tq = tquant.quantize_pytree(tconvert.params_from_numpy(params, device="cpu"), tpol)
    pairs = _pairs(jq.tree, tq.tree)
    assert len(pairs) == 4  # conv1 (channel-major view) + 3 fcs; conv0 is under min_numel
    flips = total = 0
    for a, b in pairs:
        assert b.conv_shape == a.conv_shape and b.shape == tuple(a.shape)
        np.testing.assert_allclose(b.scales.numpy(), np.asarray(a.scales), rtol=1e-6)
        flips += int((b.levels.numpy() != np.asarray(a.levels)).sum())
        total += b.levels.numel()
    assert flips <= total // 10_000, flips
    assert tquant.pytree_bits_report(tconvert.params_from_numpy(params, device="cpu"), tq) \
        == jquant.pytree_bits_report(params, jq)
    deq = tquant.dequantize_pytree(tq, like=tconvert.params_from_numpy(params, device="cpu"))
    jdeq = jquant.dequantize_pytree(jq, like=params)
    for a, b in zip(jax.tree_util.tree_leaves(jdeq), ttree.tree_leaves(deq), strict=True):
        assert tuple(b.shape) == a.shape


def test_wire_crosses_between_packages_losslessly():
    params = _lenet_params(1)
    jpol, tpol = _policies()
    jq = jquant.quantize_pytree(jax.tree_util.tree_map(jnp.asarray, params), jpol)
    tq = tquant.quantize_pytree(tconvert.params_from_numpy(params, device="cpu"), tpol)
    for src, dst in ((jq, tquant.unpack_pytree_wire(jquant.pack_pytree_wire(jq), device="cpu")),
                     (jquant.unpack_pytree_wire(tquant.pack_pytree_wire(tq)), tq)):
        for a, b in _pairs(src.tree, dst.tree):
            np.testing.assert_array_equal(np.asarray(b.levels), np.asarray(a.levels))
            np.testing.assert_array_equal(np.asarray(b.scales), np.asarray(a.scales))
            assert b.conv_shape == a.conv_shape


def _d64(seed=0):
    jm = JModel(JArch(**CFG, dtype=jnp.float32))
    jp = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(seed), jm.param_descs()))
    return jm, jp, tModel(tArch(**CFG, dtype=torch.float32))


def test_pack_params_planes_bit_equal():
    jm, params, tm = _d64()
    jp = jpacked.pack_params(jax.tree_util.tree_map(jnp.asarray, params), jm.param_descs(),
                             **PACK)
    tp = tpacked.pack_params(tconvert.params_from_numpy(params, device="cpu"),
                             tm.param_descs(), **PACK)
    jl = jax.tree_util.tree_leaves_with_path(jp, is_leaf=lambda x: hasattr(x, "planes"))
    tl = ttree.tree_leaves_with_path(tp, is_leaf=tquant.is_store)
    n_packed = diff_words = 0
    for (jpath, a), (tpath, b) in zip(jl, tl, strict=True):
        assert jax.tree_util.keystr(jpath) == ttree.keystr(tpath)
        if not hasattr(a, "planes"):
            assert not tquant.is_store(b)
            continue
        n_packed += 1
        assert isinstance(b, tquant.PackedWeight) and not (b.sign_mag or b.plane_major)
        assert (b.group_size, b.phi, b.rest_ndim) == (a.group_size, a.phi, a.rest_ndim)
        assert tuple(b.planes.shape) == a.planes.shape
        np.testing.assert_allclose(b.scales.numpy(), np.asarray(a.scales), rtol=1e-6)
        diff_words += int((b.planes.numpy() != np.asarray(a.planes)).sum())
    assert n_packed == 7  # wq wk wv wg wu wd (stacked) and the head; wo/tok stay dense
    assert diff_words == 0
    jd = jpacked.packed_param_descs(jm.param_descs(), **PACK)
    td = tpacked.packed_param_descs(tm.param_descs(), **PACK)
    jshapes = [tuple(d.shape) for d in jax.tree_util.tree_leaves(
        jd, is_leaf=lambda x: hasattr(x, "axes"))]
    tshapes = []
    for d in ttree.tree_leaves(td, is_leaf=lambda x: hasattr(x, "axes") or tquant.is_store(x)):
        tshapes += [tuple(x.shape) for x in ((d.planes, d.scales) if tquant.is_store(d) else (d,))]
    assert tshapes == jshapes
    for kw in (PACK, dict(group_size=64, min_numel=65536), dict(group_size=48, min_numel=1)):
        assert tpacked.packed_bits_report(tm.param_descs(), **kw) == \
            jpacked.packed_bits_report(jm.param_descs(), **kw)


def test_pack_params_prefill_and_decode_match_jax():
    jm, params, tm = _d64(1)
    jp = jpacked.pack_params(jax.tree_util.tree_map(jnp.asarray, params), jm.param_descs(),
                             **PACK)
    tp = tpacked.pack_params(tconvert.params_from_numpy(params, device="cpu"),
                             tm.param_descs(), **PACK)
    toks = np.array([[0, 0, 5, 9, 2, 8], [1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 7, 7]], np.int32)
    lens = np.array([4, 6, 2], np.int32)
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(3, 16))
    tc = tinit(tm.cache_descs(3, 16), device="cpu")
    jc, jl = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(lens))
    tc, tl = tm.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    jcur = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tcur = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(3):
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        jl, jc = jm.decode(jp, jc, {"tokens": jcur})
        tl, tc = tm.decode(tp, tc, {"tokens": tcur})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        jcur = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tcur = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]


def test_public_api_gaps():
    """The names this slice adds: ``max_level_delta``,
    ``QualityTier.max_error_levels``, ``EdgeArtifact.arch``, the
    ``repro_torch.quant`` re-exports and ``ServeEngine.live_requests``."""
    from repro.quant import store as jstore

    for d in (0, 1, 2):
        assert tquant.max_level_delta(d) == jstore.max_level_delta(d)
        assert tapi.QualityTier("t", d).max_error_levels() == JTier("t", d).max_error_levels()
    missing = set(jquant.__all__) - set(tquant.__all__)
    assert missing == {"set_packed_matmul_kernel"}, missing
    dw = tquant.DenseWeight(torch.ones((4, 3)))
    assert dw.nbits() == 4 * 3 * 32 and dw.shape == (4, 3)
    assert torch.equal(dw.matmul(torch.ones((2, 4))), torch.full((2, 3), 4.0))
    _, params, tm = _d64()
    art = tapi.compress(tm, tconvert.params_from_numpy(params, device="cpu"), device="cpu")
    assert art.arch == CFG["name"]
    assert tapi.compress(None, {"w": torch.ones((64, 64))}, device="cpu").arch == ""
    eng = art.engine(quality="hi", batch_slots=2, max_prompt=8, max_len=32, device="cpu")
    assert eng.live_requests == []
    rids = [eng.submit([1, 2, 3], max_new=4), eng.submit([4, 5], max_new=6),
            eng.submit([7], max_new=2)]
    eng.step()
    assert [r.rid for r in eng.live_requests] == rids[:2]
    eng.run_until_drained()
    assert eng.live_requests == []


def test_from_wire_serves_a_trained_model(monkeypatch):
    """Train the smollm smoke config 25 steps, QSQ-encode it to the wire,
    serve it through ``ServeEngine.from_wire`` on the CPU path: 5 tokens,
    equal to the JAX engine's from the same wire; without ``device`` and
    without CUDA it raises."""
    from repro_torch.configs import get_arch

    cfg = get_arch("smollm_135m", smoke=True)
    model = tModel(cfg)
    data = tdata.LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(total_steps=25, log_every=5,
                                                        opt=toptim.AdamWConfig(lr=3e-3)),
                          lambda s: tdata.lm_batch(data, s), device="cpu")
    state, _ = tr.run()
    policy = tpolicy.QuantPolicy(base=tqsq.QSQConfig(group_size=16), min_numel=512)
    wire = tquant.pack_pytree_wire(tquant.quantize_pytree(state.params, policy))
    with pytest.warns(DeprecationWarning):
        eng = tengine.ServeEngine.from_wire(model, wire, tengine.ServeConfig(batch_slots=2),
                                            device="cpu")
    outs = eng.generate([[1, 2, 3]], max_new=5)
    assert len(outs[0]) == 5
    from repro.configs import get_arch as jget_arch

    with pytest.warns(DeprecationWarning):
        jeng = JServeEngine.from_wire(JModel(jget_arch("smollm_135m", smoke=True)), wire,
                                      JServeConfig(batch_slots=2))
    assert outs == jeng.generate([[1, 2, 3]], max_new=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.warns(DeprecationWarning), pytest.raises(RuntimeError, match="CUDA is not"):
        tengine.ServeEngine.from_wire(model, wire, tengine.ServeConfig(batch_slots=2))
