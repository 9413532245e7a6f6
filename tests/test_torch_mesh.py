"""The port's meshes, sharding rules and partition specs, against the JAX package.

The JAX functions take their rules and mesh sizes as dicts, as
``tests/test_sharding.py`` gives them, so no test needs 256 or 512
devices: ``sharding_rules`` reads only a mesh's axis names.  Every spec is
compared entry by entry, leaf by leaf, with the leaves' shapes too.  The
port and the JAX config modules load only inside ``port_modules`` /
``jax_config_scope`` (see ``torch_port_scope``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as P
from torch_port_scope import jax_config_scope, port_modules

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import get_arch as jget_arch
from repro.launch import mesh as jmesh
from repro.models import base as jbase
from repro.models.api import Model as JModel
from repro.quant.packed import packed_param_descs as jpacked_descs

MESHES = {"1x1": (("data", "model"), (1, 1)), "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tbase, tconfigs, tmesh, TModel, tpacked, ttree
    with port_modules():
        from repro_torch import configs as tconfigs
        from repro_torch import tree as ttree
        from repro_torch.launch import mesh as tmesh
        from repro_torch.models import base as tbase
        from repro_torch.models.api import Model as TModel
        from repro_torch.quant import packed as tpacked
        yield


@pytest.fixture(scope="module")
def jcfgs():
    """The JAX package's full configs, by arch id."""
    with jax_config_scope():
        return {a: jget_arch(a) for a in J_ARCH_IDS}


def _tmesh(name):
    axes, shape = MESHES[name]
    return tmesh.Mesh(axes, shape)


def _jrules(name, fsdp=True):
    """The JAX rules and sizes of a mesh, from its axis names alone."""
    axes, shape = MESHES[name]
    fake = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))
    return dict(jmesh.sharding_rules(fake, fsdp=fsdp)), jmesh.mesh_axis_sizes(fake)


def _jleaves(descs, rules, sizes):
    """[(shape, spec as a list)] of every JAX descriptor, in flatten order."""
    specs = jax.tree_util.tree_leaves(jbase.partition_specs(descs, rules, sizes),
                                      is_leaf=lambda x: isinstance(x, P))
    shapes = [d.shape for d in jax.tree_util.tree_leaves(descs, is_leaf=jbase.is_desc)]
    return [(tuple(s), list(p)) for s, p in zip(shapes, specs, strict=True)]


def _tleaves(descs, rules, sizes):
    """The same of the port's descriptors, walking its spec tree beside them."""
    out = []

    def leaf(d, s):
        pairs = [(d, s)] if tbase.is_desc(d) else [
            (getattr(d, f), getattr(s, f)) for f in ("planes", "scales")]
        out.extend((tuple(dd.shape), list(ss)) for dd, ss in pairs)

    ttree.tree_map(leaf, descs, tbase.partition_specs(descs, rules, sizes),
                   is_leaf=tbase._is_node)
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_sharding_rules_match_jax(name):
    for fsdp in (True, False):
        rules, sizes = _jrules(name, fsdp)
        assert dict(tmesh.sharding_rules(_tmesh(name), fsdp=fsdp)) == rules
        assert tmesh.mesh_axis_sizes(_tmesh(name)) == sizes
    assert tmesh.data_axes(_tmesh(name)) == jmesh.data_axes(
        types.SimpleNamespace(axis_names=MESHES[name][0]))


def test_meshes_plan_the_jax_shapes():
    one, pod, multi = (tmesh.make_debug_mesh(), tmesh.make_production_mesh(),
                       tmesh.make_production_mesh(multi_pod=True))
    assert (one.name, one.size, one.axis_names) == ("1x1", 1, ("data", "model"))
    assert (pod.name, pod.size, pod.axis_names) == ("16x16", 256, ("data", "model"))
    assert (multi.name, multi.size) == ("2x16x16", 512)
    assert multi.axis_names == ("pod", "data", "model")
    assert tmesh.make_debug_mesh(4, 2).shape == (4, 2)
    with pytest.raises(ValueError):
        tmesh.Mesh(("data",), (2, 2))


@pytest.mark.parametrize("shape,axes,rules,sizes", [
    ((64, 32), ("embed", "mlp"), None, None),
    ((64, 9, 8), ("embed", "heads", None), None, None),  # 9 heads: replicated
    ((32, 64), ("mlp", "vocab"), None, None),  # "model" shards the first dim only
    ((32, 16), ("batch", None), {"batch": ("pod", "data")}, {"pod": 2, "data": 4, "model": 8}),
    ((12, 16), ("batch", None), {"batch": ("pod", "data")}, {"pod": 2, "data": 4, "model": 8}),
], ids=["basic", "fallback", "axis_once", "axis_product", "product_fallback"])
def test_spec_for_shape_matches_jax(shape, axes, rules, sizes):
    rules = rules or {"batch": ("data",), "heads": ("model",), "mlp": ("model",),
                      "vocab": ("model",), "embed": ("data",), "experts": ("model",)}
    sizes = sizes or {"data": 4, "model": 8}
    assert tbase.spec_for_shape(shape, axes, rules, sizes) == \
        tuple(jbase.spec_for_shape(shape, axes, rules, sizes))
    with pytest.raises(ValueError):
        tbase.spec_for_shape(shape, axes[:-1], rules, sizes)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_partition_specs_match_jax(arch, jcfgs):
    """param_descs, packed_param_descs and cache_descs (decode_32k's batch
    and length, long_500k's for the sub-quadratic archs) on all three
    meshes, entry by entry."""
    jm, tm = JModel(jcfgs[arch]), TModel(tconfigs.get_arch(arch))
    jp, tp = jm.param_descs(), tm.param_descs()
    trees = [(jp, tp), (jpacked_descs(jp), tpacked.packed_param_descs(tp)),
             (jm.cache_descs(128, 32768), tm.cache_descs(128, 32768))]
    if tm.cfg.sub_quadratic:
        trees.append((jm.cache_descs(1, 524288), tm.cache_descs(1, 524288)))
    for name in MESHES:
        rules, sizes = _jrules(name)
        for j, t in trees:
            assert _tleaves(t, rules, sizes) == _jleaves(j, rules, sizes), (name, arch)


def test_param_counts_and_bytes_match_jax(jcfgs):
    for arch in J_ARCH_IDS:
        jm, tm = JModel(jcfgs[arch]), TModel(tconfigs.get_arch(arch))
        for j, t in ((jm.param_descs(), tm.param_descs()),
                     (jpacked_descs(jm.param_descs()),
                      tpacked.packed_param_descs(tm.param_descs())),
                     (jm.cache_descs(128, 32768), tm.cache_descs(128, 32768))):
            assert tbase.count_params(t) == jbase.count_params(j), arch
            assert tbase.param_bytes(t) == jbase.param_bytes(j), arch


def test_abstract_params_are_meta_and_shaped():
    tm = TModel(tconfigs.get_arch("qwen3_moe_30b_a3b"))
    descs = tpacked.packed_param_descs(tm.param_descs())
    ab = tbase.abstract_params(descs)
    leaves = tbase.desc_leaves(descs)
    got = ttree.tree_leaves(ttree.tree_map(
        lambda x: [x.planes, x.scales] if hasattr(x, "planes") else x, ab,
        is_leaf=lambda x: hasattr(x, "planes")))
    assert len(got) == len(leaves) > 0
    for t, d in zip(got, leaves, strict=True):
        assert t.device.type == "meta" and tuple(t.shape) == d.shape and t.dtype == d.dtype
    assert tbase.count_params(descs) == sum(t.numel() for t in got)


def test_constrain_and_data_shard_count():
    x = torch.zeros(8, 4, 16)
    assert tbase.data_shard_count() == 1
    assert tbase.constrain(x, ("batch",)) is x  # no rules: no check
    for name, shards in (("1x1", 1), ("16x16", 16), ("2x16x16", 32)):
        rules, _ = _jrules(name)
        tbase.set_activation_rules(rules, _tmesh(name))
        try:
            assert tbase.data_shard_count() == shards
            assert tbase.constrain(x, ("batch", None, "mlp")) is x
            with pytest.raises(ValueError):
                tbase.constrain(x, ("batch", None))
        finally:
            tbase.set_activation_rules(None)
    assert tbase.data_shard_count() == 1
