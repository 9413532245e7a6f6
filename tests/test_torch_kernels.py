"""The port's packed-matmul kernels: plain versions against the JAX package.

Operands are made with numpy from a seed and fed to both packages:

* the port's plain versions (``repro_torch.kernels.ref``, what the kernel
  wrappers run for CPU tensors) against ``repro.kernels.ref`` over every
  dispatch route, ragged M and N, G in {16, 32, 64}, demand_drop 0..2, both
  layouts and both code formats — dequantized weights bit-exact, outputs
  to rtol = atol = 1e-5 in f32 (two BLAS summation orders);
* the wrappers against the Pallas kernels run as the JAX package's own
  tests run them (``repro.kernels.ops.*(..., interpret=True)``);
* the port's own invariants: a masked row equals the unmasked matmul on
  ``truncate(drop)`` bit for bit, and demand-routed equals masked;
* dispatch routes M <= 16 to the GEMV kernels and larger M to the GEMM
  kernels, as the JAX ``plan`` does, and counts per call.

``test_torch_cuda.py`` holds the CUDA kernels themselves against these
plain versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from torch_port_scope import port_modules

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tdispatch, tqsq, tref, MASK_VARIANTS, PackedWeight
    with port_modules():
        from repro_torch.kernels import dispatch as tdispatch
        from repro_torch.kernels import qsq as tqsq
        from repro_torch.kernels import ref as tref
        from repro_torch.kernels.ref import MASK_VARIANTS
        from repro_torch.quant.store import PackedWeight
        yield


def _operands(m, k, n, g, *, plane_major, sign_mag, seed=0, min_drop=0):
    """numpy x (M, K) f32, planes int32 in the layout, scales (K//G, N) f32,
    per-row plane masks drawn from MASK_VARIANTS[min_drop:]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    words = rng.integers(0, 2**32, size=(k // 32, 3, n), dtype=np.uint64)
    planes = words.astype(np.uint32).view(np.int32)
    if plane_major:
        planes = np.ascontiguousarray(np.flip(np.moveaxis(planes, 1, 0), axis=0))
    scales = rng.uniform(0.01, 0.1, size=(k // g, n)).astype(np.float32)
    mask = rng.choice(np.array(MASK_VARIANTS[min_drop:], np.int32), size=m)
    return x, planes, scales, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _xs(x, mask, demand):
    return np.stack([np.where((mask == v)[:, None], x, 0) for v in MASK_VARIANTS[demand:]])


LAYOUTS = [(True, True), (False, True), (True, False), (False, False)]  # (pm, sm)


@pytest.mark.parametrize("plane_major,sign_mag", LAYOUTS)
def test_dequant_bit_exact_vs_jax(plane_major, sign_mag):
    # interleaved planes always stream all 3 planes; plane-major reads a prefix
    for n_planes in (1, 2, 3) if plane_major else (3,):
        for g in (16, 32, 64):
            _, planes, scales, _ = _operands(4, 128, 40, g, plane_major=plane_major,
                                             sign_mag=sign_mag, seed=g)
            jw = np.asarray(jref.qsq_dequant_ref(
                jnp.asarray(planes), jnp.asarray(scales), g, sign_mag=sign_mag,
                plane_major=plane_major, n_planes=n_planes))
            tw = tref.qsq_dequant_ref(_t(planes), _t(scales), g, sign_mag=sign_mag,
                                      plane_major=plane_major, n_planes=n_planes)
            np.testing.assert_array_equal(tw.numpy(), jw)
            # every code mask ANDed on first (the masked dequant)
            for code_mask in range(8):
                jw = np.asarray(jref.qsq_dequant_masked_ref(
                    jnp.asarray(planes), jnp.asarray(scales), g, code_mask,
                    sign_mag=sign_mag, plane_major=plane_major, n_planes=n_planes))
                tw = tref.qsq_dequant_masked_ref(_t(planes), _t(scales), g, code_mask,
                                                 sign_mag=sign_mag, plane_major=plane_major,
                                                 n_planes=n_planes)
                np.testing.assert_array_equal(tw.numpy(), jw)


ROUTES = [(3, 64, 48), (8, 128, 200), (16, 96, 32), (20, 64, 72), (64, 128, 40)]


@pytest.mark.parametrize("m,k,n", ROUTES)
def test_plain_matmuls_vs_jax_ref_served_layout(m, k, n):
    """Plane-major sign-magnitude (what serve_tree produces), every route."""
    for g in (16, 32):
        for demand in (0, 1, 2):
            _check_served_layout(m, k, n, g, demand)


def _check_served_layout(m, k, n, g, demand):
    x, planes, scales, mask = _operands(m, k, n, g, plane_major=True, sign_mag=True,
                                        seed=m + n + g, min_drop=demand)
    kw = dict(sign_mag=True, plane_major=True)
    want = np.asarray(jref.qsq_matmul_ref(jnp.asarray(x), jnp.asarray(planes),
                                          jnp.asarray(scales), g, n_planes=3 - demand, **kw))
    got = tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), group_size=g,
                                  demand_drop=demand, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_m = np.asarray(jref.qsq_matmul_masked_ref(
        jnp.asarray(_xs(x, mask, demand)), jnp.asarray(planes), jnp.asarray(scales), g,
        demand_drop=demand, **kw))
    got_m = tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), group_size=g,
                                    plane_mask=_t(mask), demand_drop=demand, **kw)
    np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)


@pytest.mark.parametrize("plane_major,sign_mag", LAYOUTS)
def test_plain_matmuls_vs_jax_ref_all_layouts(plane_major, sign_mag):
    k, n = 128, 56
    kw = dict(sign_mag=sign_mag, plane_major=plane_major)
    for g in (16, 64):
        for m in (5, 24):  # both routes
            x, planes, scales, mask = _operands(m, k, n, g, plane_major=plane_major,
                                                sign_mag=sign_mag, seed=7 * m + g)
            want = np.asarray(jref.qsq_matmul_ref(jnp.asarray(x), jnp.asarray(planes),
                                                  jnp.asarray(scales), g, **kw))
            got = tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), group_size=g, **kw)
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            want_m = np.asarray(jref.qsq_matmul_masked_ref(
                jnp.asarray(_xs(x, mask, 0)), jnp.asarray(planes), jnp.asarray(scales), g,
                **kw))
            got_m = tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), group_size=g,
                                            plane_mask=_t(mask), **kw)
            np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)


# (wrapper, jax op, masked, m): both GEMV kernels at M <= 16, both GEMM above
PALLAS = [
    ("qsq_matvec", "qsq_matvec", False, 8),
    ("qsq_matvec_masked", "qsq_matvec_masked", True, 6),
    ("qsq_matmul", "qsq_matmul", False, 24),
    ("qsq_matmul_masked", "qsq_matmul_masked", True, 40),
]


@pytest.mark.parametrize("name,op,masked,m", PALLAS)
def test_wrappers_vs_pallas_interpret(name, op, masked, m):
    k, n, g = 128, 48, 32
    for plane_major, demand in ((True, 0), (True, 2), (False, 0)):
        x, planes, scales, mask = _operands(m, k, n, g, plane_major=plane_major,
                                            sign_mag=True, seed=m, min_drop=demand)
        kw = dict(sign_mag=True, plane_major=plane_major, demand_drop=demand)
        jx = jnp.asarray(_xs(x, mask, demand)) if masked else jnp.asarray(x)
        want = np.asarray(getattr(jops, op)(jx, jnp.asarray(planes), jnp.asarray(scales),
                                            group_size=g, interpret=True, **kw))
        fn = getattr(tqsq, name)
        args = (_t(x), _t(mask)) if masked else (_t(x),)
        got = fn(*args, _t(planes), _t(scales), group_size=g, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,plane_major", [(6, True), (33, False)])
def test_masked_row_equals_truncated_bit_for_bit(m, plane_major):
    k, n, g = 96, 40, 16
    x, planes, scales, mask = _operands(m, k, n, g, plane_major=plane_major,
                                        sign_mag=True, seed=11 * m)
    pw = PackedWeight(planes=_t(planes), scales=_t(scales), group_size=g, phi=4,
                      rest_ndim=1, sign_mag=True, plane_major=plane_major)
    masked = pw.matmul(_t(x), plane_mask=_t(mask)).numpy()
    for drop, code_mask in enumerate(MASK_VARIANTS):
        rows = mask == code_mask
        if not rows.any():
            continue
        trunc = pw.truncate(drop).matmul(_t(x)).numpy()
        np.testing.assert_array_equal(masked[rows], trunc[rows])


@pytest.mark.parametrize("m,demand", [(7, 2), (30, 1)])
def test_demand_routed_equals_masked_bit_for_bit(m, demand):
    k, n, g = 64, 36, 16
    x, planes, scales, mask = _operands(m, k, n, g, plane_major=True, sign_mag=True,
                                        seed=m + demand, min_drop=demand)
    kw = dict(group_size=g, plane_mask=_t(mask), sign_mag=True, plane_major=True)
    full = tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), demand_drop=0, **kw)
    routed = tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), demand_drop=demand, **kw)
    np.testing.assert_array_equal(routed.numpy(), full.numpy())


def test_plan_routes_like_jax():
    want = {jdispatch.ROUTE_GEMV: tdispatch.ROUTE_GEMV,
            jdispatch.ROUTE_GEMM: tdispatch.ROUTE_GEMM}
    for m in (1, 8, 16, 17, 64, 300):
        route = tdispatch.plan(m, 576, 192, 16).route
        assert route == want[jdispatch.plan(m, 576, 192, 16, backend="cpu").route]
    assert tdispatch.GEMV_M_MAX == jdispatch.GEMV_M_MAX
    with pytest.raises(ValueError):
        tdispatch.plan(4, 48, 16, 16)
    with pytest.raises(ValueError):
        tdispatch.plan(4, 64, 16, 48)


def test_dispatch_counts_per_call():
    x, planes, scales, mask = _operands(4, 64, 16, 16, plane_major=True, sign_mag=True,
                                        min_drop=1)
    tdispatch.reset_counters()
    try:
        for _ in range(3):
            tdispatch.packed_matmul(_t(x), _t(planes), _t(scales), group_size=16,
                                    plane_mask=_t(mask), sign_mag=True, plane_major=True,
                                    demand_drop=1)
        big = np.repeat(x, 5, axis=0)
        tdispatch.packed_matmul(_t(big), _t(planes), _t(scales), group_size=16,
                                sign_mag=True, plane_major=True)
        assert tdispatch.counters["gemv"] == 3
        assert tdispatch.counters["gemv:masked"] == 3
        assert tdispatch.counters["gemm"] == 1
        words = 64 // 32 * 16
        assert tdispatch.traffic["plane_words_read"] == 3 * 2 * words + 3 * words
        assert tdispatch.traffic["plane_words_full"] == 4 * 3 * words
        assert tdispatch.traffic["gemv:planes2"] == 3
    finally:
        tdispatch.reset_counters()


def test_wrappers_reject_bad_operands():
    x, planes, scales, mask = _operands(4, 64, 16, 16, plane_major=True, sign_mag=True)
    with pytest.raises(ValueError):
        tqsq.qsq_matvec(_t(x), _t(planes)[:, :1], _t(scales), group_size=16,
                        plane_major=True)
    with pytest.raises(ValueError):
        tqsq.qsq_matvec(_t(x), _t(planes), _t(scales), group_size=32, plane_major=True)
    with pytest.raises(ValueError):
        tqsq.qsq_matmul(_t(x), _t(planes), _t(scales), group_size=16, demand_drop=1)
    # CPU tensors run the plain version: no kernel launch is counted
    before = dict(tqsq.launches)
    tqsq.qsq_matvec_masked(_t(x), _t(mask), _t(planes), _t(scales), group_size=16,
                           sign_mag=True, plane_major=True)
    assert dict(tqsq.launches) == before
