"""The calibration fold and the dense layouts against the JAX package.

* ``compress(sensitivity=...)`` folds a calibration ranking into the
  policy as per-layer phi overrides (``budgeted_policy``), in both
  packages: for the same numpy params and ranking the two artifacts hold
  the same codes, phi per leaf and ``n_overrides``, and scales within
  rtol 1e-6 (the two f32 summation orders).
* ``sensitivity_rank`` (a torch ``loss_fn``) orders the d64 config's
  layers as the JAX one does; ``budgeted_policy`` gives equal overrides.
* ``EdgeArtifact.dense_params`` and ``serve_params(packed=False)`` are bit
  for bit the JAX package's, at every tier, calibrated ranking or not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import api as japi
from repro.configs.base import ArchConfig as JArch
from repro.core import policy as jpolicy
from repro.models.api import Model as JModel

CFG = dict(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, TArch, params_from_numpy, TModel, is_desc, tpolicy, tree_map, \
        tree_leaves_with_path, path_str, load_wire_npz
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.configs.base import ArchConfig as TArch
        from repro_torch.convert import params_from_numpy
        from repro_torch.core import policy as tpolicy
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import is_desc
        from repro_torch.quant.artifact import load_wire_npz
        from repro_torch.tree import path_str, tree_leaves_with_path, tree_map
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


def calib_batch(seed: int = 9) -> dict:
    toks = np.random.default_rng(seed).integers(0, CFG["vocab"], (4, 16)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.fixture(scope="module")
def setup():
    """(numpy params, JAX model, port model, JAX ranking on the calibration batch)."""
    p = numpy_params(3)
    jmodel = JModel(JArch(**CFG, dtype=jnp.float32))
    tmodel = TModel(TArch(**CFG, dtype=torch.float32))
    b = calib_batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, p)
    jrank = jpolicy.sensitivity_rank(
        jparams, jmodel.loss, japi.default_policy(),
        {k: jnp.asarray(v) for k, v in b.items()})
    return p, jmodel, tmodel, jrank


def wire_leaves(path):
    """{path: wire dict} of an artifact's quantized leaves, and its meta."""
    wire, meta = load_wire_npz(path)

    def is_q(x):
        return isinstance(x, dict) and "__qsq__" in x

    return {path_str(p): leaf for p, leaf in tree_leaves_with_path(wire, is_leaf=is_q)
            if is_q(leaf)}, meta


@pytest.fixture(scope="module")
def calibrated(setup, tmp_path_factory):
    """Both packages compress the same params with the same ranking."""
    p, jmodel, tmodel, jrank = setup
    d = tmp_path_factory.mktemp("calib")
    jart = japi.compress(jmodel, jax.tree_util.tree_map(jnp.asarray, p), sensitivity=jrank)
    tart = tapi.compress(tmodel, params_from_numpy(p, device="cpu"), sensitivity=jrank,
                         device="cpu")
    return jart, tart, jart.save(d / "j.npz"), tart.save(d / "t.npz")


def test_calibrated_compress_matches_jax(calibrated):
    jart, tart, jpath, tpath = calibrated
    assert tart.policy_meta == jart.policy_meta
    assert tart.policy_meta["n_overrides"] > 0 and tart.policy_meta["calibrated"]
    assert tart.rank == tuple((p, float(s)) for p, s in jart.rank)
    jl, jmeta = wire_leaves(jpath)
    tl, tmeta = wire_leaves(tpath)
    assert sorted(jl) == sorted(tl)
    phis = set()
    for key, jleaf in jl.items():
        tleaf = tl[key]
        assert int(tleaf["phi"]) == int(jleaf["phi"]), key
        phis.add(int(jleaf["phi"]))
        np.testing.assert_allclose(tleaf["scales"], jleaf["scales"], rtol=1e-6, atol=0,
                                   err_msg=key)
        np.testing.assert_array_equal(tleaf["packed"], jleaf["packed"], err_msg=key)
    assert phis == {1, 2, 4}, "the fold must assign every quartile's phi"
    assert tmeta["integrity"] == jmeta["integrity"]


def test_sensitivity_rank_matches_jax(setup):
    p, _, tmodel, jrank = setup
    b = {k: torch.from_numpy(v) for k, v in calib_batch().items()}
    trank = tpolicy.sensitivity_rank(params_from_numpy(p, device="cpu"), tmodel.loss,
                                     tapi.default_policy(), b)
    assert [k for k, _ in trank] == [k for k, _ in jrank]
    # each delta is a difference of two f32 losses near 5.5 (ulp 4.8e-7)
    # summed in another order than XLA's: equal within a few ulps
    np.testing.assert_allclose([s for _, s in trank], [s for _, s in jrank], rtol=0,
                               atol=1e-5)


def test_budgeted_policy_overrides_match_jax(setup):
    *_, jrank = setup
    jp = jpolicy.budgeted_policy(jrank, japi.default_policy())
    tp = tpolicy.budgeted_policy(list(jrank), tapi.default_policy())
    assert sorted(tp.overrides) == sorted(jp.overrides)
    for pat, cfg in jp.overrides.items():
        assert (tp.overrides[pat].phi, tp.overrides[pat].group_size) == (cfg.phi,
                                                                          cfg.group_size)
    assert tpolicy.budgeted_policy([], tapi.default_policy()) == tapi.default_policy()


@pytest.mark.parametrize("quality", ["hi", "mid", "lo"])
def test_dense_params_bit_exact(calibrated, quality):
    """The calibrated ranking names non-packable leaves (the embedding, wo)
    too, so a tier truncates them in the dense tree as well."""
    _, _, jpath, _ = calibrated
    jd = japi.load(jpath).dense_params(quality)
    td = tapi.load(jpath).dense_params(quality, device="cpu")
    jflat = {"/".join(str(getattr(k, "key", k)) for k in p): v
             for p, v in jax.tree_util.tree_flatten_with_path(jd)[0]}
    tflat = {path_str(p): v for p, v in tree_leaves_with_path(td)}
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("quality", ["hi", "lo"])
def test_serve_params_unpacked_bit_exact(calibrated, quality):
    _, _, jpath, _ = calibrated
    jtree, jn = japi.load(jpath).serve_params(quality, packed=False)
    ttree, tn = tapi.load(jpath).serve_params(quality, packed=False, device="cpu")
    assert jn == tn == 0
    jflat = {"/".join(str(getattr(k, "key", k)) for k in p): v
             for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = {path_str(p): v for p, v in tree_leaves_with_path(ttree)}
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v), err_msg=k)


def test_calibrated_tiers_serve_packed_bit_exact(calibrated):
    """A tier that truncates a non-packable leaf (decoded at load) truncates
    it in the port's served tree too."""
    _, _, jpath, _ = calibrated
    jtree, _ = japi.load(jpath).serve_params("lo")
    ttree, _ = tapi.load(jpath).serve_params("lo", device="cpu")
    jtok = np.asarray(jtree["embed"]["tok"])
    np.testing.assert_array_equal(ttree["embed"]["tok"].numpy(), jtok)
    full, _ = tapi.load(jpath).serve_params("hi", device="cpu")
    assert not np.array_equal(full["embed"]["tok"].numpy(), jtok), \
        "lo must truncate the embedding the calibrated ranking names"


def test_dense_engine_serves_jax_tokens(calibrated):
    _, _, jpath, _ = calibrated
    prompts = [[5, 9, 2], [17, 4], [250, 1, 3, 3]]
    kw = dict(quality="mid", packed=False, batch_slots=3, max_prompt=8, max_len=24)
    jt = japi.load(jpath).engine(**kw).generate(prompts, max_new=5)
    tt = tapi.load(jpath).engine(device="cpu", **kw).generate(prompts, max_new=5)
    assert tt == jt
