"""The QSQ encoder (K5) and gradient compression: the port against the JAX package.

Weights and gradients are made with numpy from a seed and fed to both:

* the port's ``kernels.qsq_quantize`` (on CPU tensors: the plain version
  ``ref.qsq_quantize_ref``) against the Pallas kernel run as the JAX
  package's own tests run it (``ops.qsq_quantize(..., interpret=True)``)
  and against the JAX oracle ``ref.qsq_quantize_ref``, over G in {2, 16,
  64}, phi in {1, 2, 4}, a ragged N and all-zero groups.  Tolerance: at
  G = 2 the sum |a| + |b| has one order, so codes and scales are
  bit-exact; at larger G the port sums |w| in plain K order and XLA in
  its own, so scales agree to rtol 1e-6 (last f32 bit) and a code may
  differ only where |w / alpha| lies within 1e-5 (relative) of a
  nearest-level threshold;
* ``pack_weight`` -> ``qsq_matmul`` (the JAX package's own end-to-end use
  of the encoder) against the JAX chain: planes bit-exact off near-ties,
  products within rtol = atol = 1e-5 in f32 (two summation orders);
* ``compress_grads`` on identical gradients and error buffers: decoded
  gradients and new residuals within the same last-bit allowance, and
  ``grad_wire_bytes`` exact, including the 277,004,448 B per step of
  smollm-135m at its published widths (the 11 leaves K5 encodes there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro.configs import get_arch as jget_arch
from repro.core import codec as jcodec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.api import Model as JModel
from repro.optim import GradCompressionConfig as JGC
from repro.optim import compress_grads as jcompress
from repro.optim.compression import _leaf_group as jleaf_group
from repro.optim.compression import compression_state_descs as jstate_descs

K, N = 128, 50  # N = 50 divides no tile: the ragged edge


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tkernels, tqsq, tref, tcomp, tcodec, TArch, TModel, tget_arch, is_desc, tree_map, \
        tree_leaves
    with port_modules():
        from repro_torch import kernels as tkernels
        from repro_torch.configs import get_arch as tget_arch
        from repro_torch.configs.base import ArchConfig as TArch
        from repro_torch.core import codec as tcodec
        from repro_torch.kernels import qsq as tqsq
        from repro_torch.kernels import ref as tref
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import is_desc
        from repro_torch.optim import compression as tcomp
        from repro_torch.tree import tree_leaves, tree_map
        yield


def _weights(seed, shape=(K, N), g=16):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:g, :3] = 0.0  # all-zero groups: alpha 0, every code 0
    w[g:2 * g, 3] = -0.0
    return w


def _near_tie(w, alpha, g, tol=1e-5):
    """|w / alpha| within ``tol`` (relative) of a nearest-level threshold."""
    r = np.abs(w.reshape(w.shape[0] // g, g, -1) / np.where(alpha == 0, 1, alpha)[:, None])
    return np.any([np.abs(r - b) <= tol * b for b in (0.5, 1.5, 3.0)], axis=0).reshape(w.shape)


def _assert_encodings_agree(w, g, got, want):
    """``got``/``want`` = (codes (K, N), scales (K//G, N)) as numpy."""
    (tc, ts), (jc, js) = got, want
    assert tc.shape == jc.shape and ts.shape == js.shape
    if g == 2:  # one summation order: bit-exact
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tc, jc)
        return
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    diff = tc != jc
    assert not np.any(diff & ~_near_tie(w, js, g)), f"{int(diff.sum())} codes differ off ties"


@pytest.mark.parametrize("g", [2, 16, 64])
@pytest.mark.parametrize("phi", [1, 2, 4])
def test_quantize_matches_pallas_and_oracle(g, phi):
    w = _weights(g * 10 + phi, g=g)
    tc, ts = tkernels.qsq_quantize(torch.from_numpy(w), group_size=g, phi=phi)
    assert tc.dtype == torch.uint8 and ts.dtype == torch.float32
    assert int(tc.max()) <= 6
    got = (tc.numpy(), ts.numpy())
    jc, js = jops.qsq_quantize(jnp.asarray(w), group_size=g, phi=phi, interpret=True)
    _assert_encodings_agree(w, g, got, (np.asarray(jc), np.asarray(js)))
    rc, rs = jref.qsq_quantize_ref(jnp.asarray(w), g, phi)
    _assert_encodings_agree(w, g, got, (np.asarray(rc), np.asarray(rs)))
    assert not tc.numpy()[:g, :3].any() and not ts.numpy()[0, :3].any()


def test_quantize_bfloat16_input_widens_like_pallas():
    w = jnp.asarray(_weights(7), dtype=jnp.bfloat16)
    w32 = np.asarray(w, dtype=np.float32)
    t = torch.from_numpy(w32).to(torch.bfloat16)
    tc, ts = tkernels.qsq_quantize(t, group_size=16, phi=4)
    jc, js = jops.qsq_quantize(w, group_size=16, phi=4, interpret=True)
    _assert_encodings_agree(w32, 16, (tc.numpy(), ts.numpy()), (np.asarray(jc), np.asarray(js)))
    # bf16 input is widened first, so it encodes exactly as its f32 value
    c32, s32 = tkernels.qsq_quantize(torch.from_numpy(w32), group_size=16, phi=4)
    assert torch.equal(tc, c32) and torch.equal(ts, s32)


def test_pack_weight_then_qsq_matmul_matches_jax():
    g = 16
    w = _weights(11, (128, 96), g=g)
    x = np.random.default_rng(12).standard_normal((8, 128)).astype(np.float32)
    jp, js = jops.pack_weight(jnp.asarray(w), group_size=g, interpret=True)
    tp, ts = tkernels.pack_weight(torch.from_numpy(w), group_size=g)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (4, 3, 96)
    tcodes = tcodec.unpack_bitplane(tp).numpy()
    jcodes = np.asarray(jcodec.unpack_bitplane(jp))
    _assert_encodings_agree(w, g, (tcodes, ts.numpy()), (jcodes, np.asarray(js)))
    jy = np.asarray(jops.qsq_matmul(jnp.asarray(x), jp, js, group_size=g, interpret=True))
    ty = tkernels.qsq_matmul(torch.from_numpy(x), tp, ts, group_size=g).numpy()
    same_cols = ~np.any(tcodes != jcodes, axis=0)  # a column with a tie-flipped code differs
    assert same_cols.mean() > 0.9
    np.testing.assert_allclose(ty[:, same_cols], jy[:, same_cols], rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu_and_validates():
    w = torch.from_numpy(_weights(3))
    launches, calls = tqsq.launches["qsq_quantize"], tref.calls["qsq_quantize_ref"]
    codes, scales = tqsq.qsq_quantize(w, group_size=16, phi=2)
    assert tqsq.launches["qsq_quantize"] == launches  # a CPU tensor launches nothing
    assert tref.calls["qsq_quantize_ref"] == calls + 1
    assert tuple(codes.shape) == (K, N) and tuple(scales.shape) == (K // 16, N)
    assert set(np.unique(codes.numpy())) <= {0, 1, 2, 4, 5}  # phi = 2 caps at +-2
    with pytest.raises(ValueError, match="does not divide"):
        tqsq.qsq_quantize(w, group_size=48)
    with pytest.raises(ValueError, match="phi"):
        tqsq.qsq_quantize(w, group_size=16, phi=3)
    with pytest.raises(ValueError, match="matrix"):
        tqsq.qsq_quantize(w[0], group_size=1)


@pytest.mark.parametrize("shape", [(30, 576), (49152, 576), (576, 49152), (2, 64, 4, 16),
                                   (7, 5), (48, 3), (256, 64)])
def test_leaf_group_matches_jax(shape):
    for gs in (64, 16, 48):
        assert tcomp._leaf_group(shape, gs) == jleaf_group(shape, gs)


def _grads_and_errs(seed):
    """Gradients and error buffers of the d64 test config, as numpy."""
    cfg = TArch(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=128, vocab=256, dtype=torch.float32, remat=False)
    descs = TModel(cfg).param_descs()
    err_descs = tcomp.compression_state_descs(descs, tcomp.GradCompressionConfig(enabled=True))
    rng = np.random.default_rng(seed)
    grads = tree_map(lambda d: (rng.standard_normal(d.shape) * 0.01).astype(np.float32),
                     descs, is_leaf=is_desc)
    errs = tree_map(lambda d: (rng.standard_normal(d.shape) * 0.002).astype(np.float32)
                    if d.shape else np.zeros((), np.float32), err_descs, is_leaf=is_desc)
    return grads, errs


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], path + (key,)).items()}
    return {"/".join(path): np.asarray(tree)}


def test_compress_grads_matches_jax():
    grads, errs = _grads_and_errs(0)
    jd, je, jb = jcompress(_to_jnp(grads), _to_jnp(errs), JGC(enabled=True))
    td, te, tb = tcomp.compress_grads(tree_map(torch.from_numpy, grads),
                                      tree_map(torch.from_numpy, errs),
                                      tcomp.GradCompressionConfig(enabled=True))
    assert isinstance(tb, float) and tb == float(jb) == 189440.0
    jd, je = _flat(jd), _flat(je)
    td, te = _flat(tree_map(lambda t: t.numpy(), td)), _flat(tree_map(lambda t: t.numpy(), te))
    g_all, e_all = _flat(grads), _flat(errs)
    n_compressed = 0
    for path, g in g_all.items():
        if e_all[path].ndim == 0:  # crosses uncompressed
            np.testing.assert_array_equal(td[path], g)
            np.testing.assert_array_equal(te[path], e_all[path])
            continue
        n_compressed += 1
        scale = np.max(np.abs(jd[path]))
        if g.shape[0] == 2:  # stacked leaves group along L: G = 2, bit-exact
            np.testing.assert_array_equal(td[path], jd[path])
            np.testing.assert_array_equal(te[path], je[path])
        else:  # G = 64: last-bit scales
            np.testing.assert_allclose(td[path], jd[path], rtol=1e-6, atol=1e-6 * scale)
            np.testing.assert_allclose(te[path], je[path], rtol=0, atol=2e-6 * scale)
    assert n_compressed == 9


def _to_jnp(tree):
    return {k: _to_jnp(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        jnp.asarray(tree)


def test_compress_disabled_passes_through():
    grads, errs = _grads_and_errs(1)
    tg = tree_map(torch.from_numpy, grads)
    out, err, wire = tcomp.compress_grads(tg, errs, tcomp.GradCompressionConfig())
    assert out is tg and err is errs and wire == 0.0


def _wire_bytes(descs, err_descs, group_size, leaf_group, ndim, size):
    """(3 * values + 32 * scales) / 8 over the compressed leaves, and the
    K5 shapes (K, N) with their G, from descriptors alone."""
    bits, shapes = 0, []
    for d, e in zip(descs, err_descs, strict=True):
        if ndim(e) == 0:
            continue
        k = d.shape[0]
        n = size(d) // k
        g = leaf_group((k, n), group_size)
        bits += 3 * k * n + 32 * (k // g) * n
        shapes.append((k, n, g))
    return bits / 8, sorted(shapes)


def test_smollm_135m_wire_bytes_and_k5_shapes():
    """At the published widths 11 leaves are encoded per step (11 K5
    launches), and both packages' formula gives 277,004,448 B."""
    tdescs = TModel(tget_arch("smollm_135m")).param_descs()
    cc = tcomp.GradCompressionConfig(enabled=True)
    t_bytes, t_shapes = _wire_bytes(
        tree_leaves(tdescs, is_leaf=is_desc),
        tree_leaves(tcomp.compression_state_descs(tdescs, cc), is_leaf=is_desc),
        cc.group_size, tcomp._leaf_group, lambda d: len(d.shape),
        lambda d: int(np.prod(d.shape)))
    jdescs = JModel(jget_arch("smollm_135m")).param_descs()
    j_is_desc = lambda x: hasattr(x, "axes")  # noqa: E731
    j_bytes, j_shapes = _wire_bytes(
        jax.tree_util.tree_leaves(jdescs, is_leaf=j_is_desc),
        jax.tree_util.tree_leaves(jstate_descs(jdescs, JGC(enabled=True)), is_leaf=j_is_desc),
        64, jleaf_group, lambda d: len(d.shape), lambda d: int(np.prod(d.shape)))
    assert t_bytes == j_bytes == 277_004_448
    assert t_shapes == j_shapes
    assert len(t_shapes) == 11
    assert sum(k * n for k, n, _ in t_shapes) == 162_825_984
    assert (49152, 576, 64) in t_shapes and (576, 49152, 64) in t_shapes
    assert {g for k, _, g in t_shapes if k == 30} == {2}
