"""The paper's CNNs in the port against the JAX package.

Both packages get the same parameters and images, made with numpy from a
seed.  Tolerances, with why:

* ``cnn_forward`` logits and ``cnn_loss`` within rtol = atol = 1e-5 at
  batch 4, for LeNet and ConvNet4: two libraries' f32 convolutions and
  matmuls sum in different orders (checked against ``cnn_forward``
  directly, not through ``test_models.py::test_cnn_forward_shapes``);
* 5 AdamW steps of LeNet from the same params on the same batches: every
  parameter within 1e-5 (absolute and relative);
* ``finetune_fc`` against ``benchmarks/common.py::finetune_fc``: the convs
  bit for bit unchanged in both, the fcs within 1e-5;
* the synthetic images, labels and batches are numpy in both packages, so
  they are equal bit for bit.

The port's own pipeline (LeNet, 150 steps on the CPU) must reach the bounds
of ``test_system.py::test_lenet_paper_pipeline``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro.data.pipeline import image_batches as jbatches
from repro.data.pipeline import synthetic_image_dataset as jdataset
from repro.models import cnn as jcnn
from repro.optim import AdamWConfig as JAdamW
from repro.optim import OptState as JOptState
from repro.optim import adamw_update as jadamw

CFGS = {"lenet": jcnn.LENET, "convnet4": jcnn.CONVNET4}


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tcnn, tdata, tconvert, ttrain, toptim, tpolicy, tqsq, tquant, ttree
    with port_modules():
        import repro_torch.convert as tconvert
        import repro_torch.core.policy as tpolicy
        import repro_torch.core.qsq as tqsq
        import repro_torch.data.pipeline as tdata
        import repro_torch.models.cnn as tcnn
        import repro_torch.optim as toptim
        import repro_torch.quant as tquant
        import repro_torch.train.cnn as ttrain
        import repro_torch.tree as ttree
        yield


def _np_params(cfg, seed=0):
    """He-scaled numpy params in the JAX layouts (conv HWIO, fc (in, out))."""
    rng = np.random.default_rng(seed)
    out = {"convs": [], "fcs": []}
    for cs in cfg.convs:
        w = rng.standard_normal((cs.kh, cs.kw, cs.cin, cs.cout)) / np.sqrt(cs.kh * cs.kw * cs.cin)
        out["convs"].append({"w": w.astype(np.float32),
                             "b": (0.1 * rng.standard_normal(cs.cout)).astype(np.float32)})
    dims = [jcnn._flat_dim(cfg), *cfg.fc, cfg.n_classes]
    for a, b in zip(dims[:-1], dims[1:]):
        out["fcs"].append({"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                           "b": (0.1 * rng.standard_normal(b)).astype(np.float32)})
    return out


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_tree(tree):
    return tconvert.params_from_numpy(tree, device="cpu")


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cnn_forward_and_loss_match_jax(name):
    jc, tc = CFGS[name], getattr(tcnn, name.upper())
    params = _np_params(jc)
    rng = np.random.default_rng(1)
    images = rng.random((4, *jc.input_hw, jc.input_c), dtype=np.float32)
    labels = rng.integers(0, jc.n_classes, 4).astype(np.int32)
    jl = jcnn.cnn_forward(_jax(params), jc, jnp.asarray(images))
    tl = tcnn.cnn_forward(_port_tree(params), tc, torch.from_numpy(images))
    assert tl.shape == (4, jc.n_classes) and tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    batch = {"images": images, "labels": labels}
    _close(float(tcnn.cnn_loss(_port_tree(params), tc, {k: torch.from_numpy(v) for k, v in
                                                         batch.items()})),
           float(jcnn.cnn_loss(_jax(params), jc, _jax(batch))))
    assert tcnn.cnn_accuracy(_port_tree(params), tc, images, labels) == pytest.approx(
        jcnn.cnn_accuracy(_jax(params), jc, jnp.asarray(images), jnp.asarray(labels)))


def _same_config(tc, jc) -> bool:
    return (tc.name, tc.input_hw, tc.input_c, tc.fc, tc.n_classes) == (
        jc.name, jc.input_hw, jc.input_c, jc.fc, jc.n_classes) and [
        (c.kh, c.kw, c.cin, c.cout, c.pool) for c in tc.convs] == [
        (c.kh, c.kw, c.cin, c.cout, c.pool) for c in jc.convs]


def test_descs_and_conv_layer_shapes_match_jax():
    for name, jc in CFGS.items():
        tc = getattr(tcnn, name.upper())
        assert _same_config(tc, jc)
        assert [(s.name, s.h, s.w, s.c, s.num, s.numel) for s in tcnn.conv_layer_shapes(tc)] \
            == [(s.name, s.h, s.w, s.c, s.num, s.numel) for s in jcnn.conv_layer_shapes(jc)]
        jd = jax.tree_util.tree_leaves(jcnn.cnn_descs(jc), is_leaf=lambda d: hasattr(d, "axes"))
        td = ttree.tree_leaves(tcnn.cnn_descs(tc), is_leaf=lambda d: hasattr(d, "axes"))
        assert [(d.shape, d.init) for d in td] == [(d.shape, d.init) for d in jd]


def test_params_cross_from_numpy_unchanged():
    """``convert.params_from_numpy`` carries the JAX CNN tree (lists of
    dicts) across as the same structure with equal values."""
    params = _np_params(jcnn.LENET)
    tp = tconvert.params_from_numpy(jax.tree_util.tree_map(np.asarray, _jax(params)),
                                    device="cpu")
    assert set(tp) == {"convs", "fcs"} and isinstance(tp["convs"], list)
    for (pj, j), (pt, t) in zip(jax.tree_util.tree_leaves_with_path(params),
                                ttree.tree_leaves_with_path(tp), strict=True):
        assert jax.tree_util.keystr(pj) == ttree.keystr(pt)
        np.testing.assert_array_equal(t.numpy(), j)


def test_image_data_bit_equal():
    ji, jl = jdataset(96, (28, 28), 1, 10, seed=3, noise=0.3)
    ti, tl = tdata.synthetic_image_dataset(96, (28, 28), 1, 10, seed=3, noise=0.3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    jit_ = jbatches(ji, jl, 16, seed=5, start_step=2)
    tit = tdata.image_batches(ti, tl, 16, seed=5, start_step=2, device="cpu")
    for _ in range(3):
        (js, jb), (ts, tb) = next(jit_), next(tit)
        assert js == ts
        np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
        np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))


def test_adamw_steps_match_jax():
    """5 AdamW steps of LeNet (lr 2e-3, no decay) from one numpy state."""
    cfg = jcnn.LENET
    params = _np_params(cfg)
    imgs, labels = jdataset(128, cfg.input_hw, cfg.input_c, cfg.n_classes, seed=0, noise=0.3)
    jcfg = JAdamW(lr=2e-3, weight_decay=0.0)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, _jax(params))
    jopt = JOptState(m=zeros, v=zeros, step=jnp.zeros((), jnp.int32))

    @jax.jit
    def jstep(p, o, b):
        g = jax.grad(lambda q: jcnn.cnn_loss(q, cfg, b))(p)
        p, o, _ = jadamw(jcfg, p, g, o)
        return p, o

    tparams = _port_tree(params)
    tzeros = ttree.tree_map(torch.zeros_like, tparams)
    topt = toptim.OptState(m=tzeros, v=tzeros, step=torch.zeros((), dtype=torch.int32))
    tcfg = toptim.AdamWConfig(lr=2e-3, weight_decay=0.0)
    jp = _jax(params)
    for (_, jb), (_, tb) in zip(jbatches(imgs, labels, 32, seed=1),
                                tdata.image_batches(imgs, labels, 32, seed=1), strict=False):
        jp, jopt = jstep(jp, jopt, jb)
        tparams, topt, _ = ttrain.cnn_train_step(tcfg, tcnn.LENET, tparams, topt, tb)
        if int(topt.step) == 5:
            break
    for j, t in zip(jax.tree_util.tree_leaves(jp), ttree.tree_leaves(tparams), strict=True):
        _close(t.numpy(), j)


def test_finetune_fc_matches_jax():
    """``finetune_fc`` zeroes the conv gradients exactly as the reference:
    3 steps from one state, convs untouched in both, fcs within 1e-5."""
    from benchmarks.common import finetune_fc as jfinetune_fc

    cfg = jcnn.LENET
    params = _np_params(cfg, seed=2)
    imgs, labels = jdataset(128, cfg.input_hw, cfg.input_c, cfg.n_classes, seed=0, noise=0.3)
    jp = jfinetune_fc(_jax(params), cfg, imgs, labels, steps=3)
    tp = ttrain.finetune_fc(_port_tree(params), tcnn.LENET, imgs, labels, steps=3)
    for i, conv in enumerate(tp["convs"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(conv[k].numpy(), params["convs"][i][k])
            np.testing.assert_array_equal(np.asarray(jp["convs"][i][k]), params["convs"][i][k])
    for j, t in zip(jax.tree_util.tree_leaves(jp["fcs"]), ttree.tree_leaves(tp["fcs"]),
                    strict=True):
        _close(t.numpy(), j)
    assert not np.array_equal(tp["fcs"][0]["w"].numpy(), params["fcs"][0]["w"])


def test_port_lenet_pipeline_reaches_reference_bounds():
    """The bounds of ``test_system.py::test_lenet_paper_pipeline`` on the
    port alone: float accuracy > 0.85 after 150 steps, the refit phi = 4
    tree within 0.15 of it, and more zeros in the quantized leaves."""
    params, tr_i, tr_l, ev_i, ev_l = ttrain.train_cnn(tcnn.LENET, steps=150, device="cpu")
    acc = tcnn.cnn_accuracy(params, tcnn.LENET, ev_i, ev_l)
    assert acc > 0.85, acc
    policy = tpolicy.QuantPolicy(base=tqsq.QSQConfig(phi=4, group_size=16, refit_alpha=True),
                                 min_numel=256)
    qp = tquant.quantize_pytree(params, policy)
    acc_q = tcnn.cnn_accuracy(tquant.dequantize_pytree(qp, like=params), tcnn.LENET, ev_i,
                              ev_l)
    assert acc_q > acc - 0.15, (acc, acc_q)
    pairs = [(w, q) for w, q in zip(ttree.tree_leaves(params),
                                    ttree.tree_leaves(qp.tree, is_leaf=tquant.is_store),
                                    strict=True) if tquant.is_store(q)]
    assert pairs
    z_fp = sum(float(tqsq.zeros_fraction(w)) for w, _ in pairs)
    z_q = sum(float(tqsq.zeros_fraction(q.levels)) for _, q in pairs)
    assert z_q > z_fp
