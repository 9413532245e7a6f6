"""EdgeArtifact parity: the npz crosses between the JAX package and the port.

* A JAX ``api.compress(...).save()`` artifact loads in the port, and the
  port's served tree (``serve_params(per_request=True)``) is bit-exact
  against the JAX one: planes, scales, tier-drop vectors and the leaves
  decoded once at load.
* Artifacts corrupted with the JAX fault harness (``corrupt_plane_npz``)
  give the same tier ceiling in both packages, or the same hard
  ``ArtifactIntegrityError``.
* A port-written artifact loads in the JAX package and serves the same
  greedy tokens there as the port serves.

Weights are drawn with numpy from a seed and handed to both packages.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import api as japi
from repro.configs.base import ArchConfig as JArch
from repro.models.api import Model as JModel
from repro.quant.store import PackedWeight as JPacked
from repro.serve.faults import corrupt_plane_npz

CFG = dict(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, TArch, params_from_numpy, TModel, is_desc, TPacked, path_str, \
        tree_leaves_with_path, tree_map
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.configs.base import ArchConfig as TArch
        from repro_torch.convert import params_from_numpy
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import is_desc
        from repro_torch.quant.store import PackedWeight as TPacked
        from repro_torch.tree import path_str, tree_leaves_with_path, tree_map
        yield


def numpy_params(seed: int) -> dict:
    """The d64 bench config's parameters, drawn with numpy (fan-in scaled)."""
    rng = np.random.default_rng(seed)
    descs = TModel(TArch(**CFG, dtype=torch.float32)).param_descs()

    def draw(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return tree_map(draw, descs, is_leaf=is_desc)


def jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JPacked))[0]
    out = {}
    for p, leaf in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in p]
        out["/".join(parts)] = leaf
    return out


def torch_leaves(tree):
    return {path_str(p): leaf
            for p, leaf in tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(
                x, TPacked))}


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    model = JModel(JArch(**CFG, dtype=jnp.float32))
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(0))
    art = japi.compress(model, params)
    path = art.save(tmp_path_factory.mktemp("jax_art") / "model.edge.npz")
    return art, path


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    model = TModel(TArch(**CFG, dtype=torch.float32))
    params = params_from_numpy(numpy_params(1), device="cpu")
    art = tapi.compress(model, params, device="cpu")
    path = art.save(tmp_path_factory.mktemp("port_art") / "model.edge.npz")
    return art, path


def assert_served_trees_equal(jtree, ttree):
    jl, tl = jax_leaves(jtree), torch_leaves(ttree)
    assert sorted(jl) == sorted(tl)
    n_packed = 0
    for p, jleaf in jl.items():
        tleaf = tl[p]
        if isinstance(jleaf, JPacked):
            n_packed += 1
            assert isinstance(tleaf, TPacked), p
            np.testing.assert_array_equal(tleaf.planes.numpy(), np.asarray(jleaf.planes))
            np.testing.assert_array_equal(tleaf.scales.numpy(), np.asarray(jleaf.scales))
            assert tleaf.tier_drops == jleaf.tier_drops, p
            assert (tleaf.sign_mag, tleaf.plane_major, tleaf.n_planes, tleaf.group_size,
                    tleaf.rest_ndim) == (jleaf.sign_mag, jleaf.plane_major, jleaf.n_planes,
                                         jleaf.group_size, jleaf.rest_ndim), p
        else:
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf), err_msg=p)
    return n_packed


def test_jax_artifact_served_tree_bit_exact(jax_artifact):
    jart, path = jax_artifact
    tart = tapi.load(path)
    jtree, jn = japi.load(path).serve_params("mid", per_request=True)
    ttree, tn = tart.serve_params("mid", per_request=True, device="cpu")
    assert jn == tn == 7  # 6 stacked projections + the head
    assert assert_served_trees_equal(jtree, ttree) == 7


def test_jax_artifact_meta_and_tiers_equal(jax_artifact):
    jart, path = jax_artifact
    tart = tapi.load(path)
    assert tart.quality_names() == jart.quality_names()
    assert [p for p, _ in tart.rank] == [p for p, _ in jart.rank]
    assert tart.tier_drop_vectors() == jart.tier_drop_vectors()
    for q in tart.quality_names():
        assert tart.drop_map(q) == jart.drop_map(q)
    assert tart.plane_integrity() == japi.load(path).plane_integrity()
    assert tart.policy_meta == jart.policy_meta
    assert tart.arch_config == TArch(**CFG, dtype=torch.float32)


@pytest.mark.parametrize("quality", ["hi", "lo"])
def test_jax_artifact_single_tier_tree_bit_exact(jax_artifact, quality):
    _, path = jax_artifact
    jtree, _ = japi.load(path).serve_params(quality)
    ttree, _ = tapi.load(path).serve_params(quality, device="cpu")
    assert assert_served_trees_equal(jtree, ttree) == 7


# (MSB-first plane, leaf substring): sign-plane damage is fatal; LSB damage
# on a leaf some tier truncates caps the ceiling; damage no tier absorbs
# raises at the ceiling lookup
CORRUPTIONS = [(0, None), (0, "wd"), (1, "head"), (1, "wq"), (2, "wg"), (2, "head"),
               (2, "wv")]


@pytest.mark.parametrize("plane,leaf", CORRUPTIONS)
def test_corrupted_artifact_same_outcome(jax_artifact, tmp_path, plane, leaf):
    _, path = jax_artifact
    bad = corrupt_plane_npz(path, plane, leaf=leaf, n_flips=8, seed=plane,
                            out=tmp_path / "bad.edge.npz")

    def outcome(load, err_type):
        try:
            art = load(bad)
        except err_type as e:
            return ("load-error", type(e).__name__)
        try:
            return ("ceiling", art.tier_ceiling_index(), dict(art.plane_damage))
        except err_type as e:
            return ("ceiling-error", type(e).__name__, dict(art.plane_damage))

    j = outcome(japi.load, japi.ArtifactIntegrityError)
    t = outcome(tapi.load, tapi.ArtifactIntegrityError)
    assert t == j
    if plane == 0:
        assert j[0] == "load-error"


def test_corrupted_lsb_serves_repaired_tree_bit_exact(jax_artifact, tmp_path):
    _, path = jax_artifact
    bad = corrupt_plane_npz(path, 2, leaf="wg", n_flips=8, out=tmp_path / "bad.edge.npz")
    jart, tart = japi.load(bad), tapi.load(bad)
    assert tart.plane_damage == jart.plane_damage != {}
    jtree, _ = jart.serve_params("lo", per_request=True)
    ttree, _ = tart.serve_params("lo", per_request=True, device="cpu")
    assert_served_trees_equal(jtree, ttree)


def test_port_artifact_roundtrip_and_loads_in_jax(port_artifact, tmp_path):
    tart, path = port_artifact
    again = tapi.load(path)
    assert again.rank == tuple((p, s) for p, s in tart.rank)
    assert again.plane_integrity() == tart.plane_integrity()
    jart = japi.load(path)  # verifies the port-written CRCs in the JAX package
    assert jart.plane_damage == {}
    assert jart.arch_config.name == CFG["name"]
    assert jart.tier_drop_vectors() == tart.tier_drop_vectors()
    jtree, _ = jart.serve_params("hi", per_request=True)
    ttree, _ = again.serve_params("hi", per_request=True, device="cpu")
    assert assert_served_trees_equal(jtree, ttree) == 7
    copy = shutil.copy(path, tmp_path / "copy.edge.npz")
    assert tapi.load(copy).tier_ceiling_index() == 0


def test_port_artifact_serves_same_tokens_in_jax(port_artifact):
    _, path = port_artifact
    prompts = [[5, 9, 2], [17], [3, 3, 3, 3, 8, 1], [250, 1]]
    qualities = ["hi", "mid", "lo", "mid"]
    kw = dict(quality="hi", batch_slots=4, max_prompt=8, max_len=24)
    jtoks = japi.load(path).engine(**kw).generate(prompts, max_new=5, qualities=qualities)
    ttoks = tapi.load(path).engine(device="cpu", **kw).generate(prompts, max_new=5,
                                                                 qualities=qualities)
    assert ttoks == jtoks
