"""The paper's analytic pieces in the port against the JAX package: the
Eq. 11/12 memory and energy model, the CSD multipliers (Fig. 11) and the
qsq helpers.

* Eq. 11/12, ``model_savings`` and ``roofline_terms`` (with explicit
  constants) are integer and Python-float arithmetic: equal exactly.
* ``csd_digit_count`` / ``csd_nonzero_histogram``: equal bit for bit (the
  port counts in int64, the JAX package in uint32).
* ``csd_round``: every digit's exponent is the same, so the values agree
  within rtol 1e-6, except at elements where a residual lands on a
  boundary (within one f32 ulp of 2^e, 1.5 * 2^e or the cut-off
  2^(min_exp - 1)) and a digit takes the other exponent or the other side
  of the cut-off (counted: at most 1 in 10^4, each one checked to sit on
  such a boundary).  The values are not bit-equal because XLA's f32
  ``exp2`` on the CPU is off by up to 4.8e-7 (relative) at some integer
  exponents (2^-13 among them), where torch's is exact; so a residual of
  exactly 2^-17 (the cut-off ``2^(min_exp - 1)``) keeps a digit in JAX
  and rounds to 0 in the port.
* ``partial_product_savings``: within 1e-6 (f32 sums of integer counts).
* ``levels_for_phi`` exact; ``zeros_fraction`` within rtol 1e-6 (an f32
  mean of 0/1 values, divided in another order); ``quantization_error``
  within rtol 1e-5; ``exhaustive_threshold_search`` picks the same
  (delta, gamma) on a small grid.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from torch_port_scope import port_modules

from repro.core import csd as jcsd
from repro.core import energy as jenergy
from repro.core import qsq as jqsq
from repro.models import cnn as jcnn


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tcore, tcsd, tenergy, tqsq, tcnn
    with port_modules():
        import repro_torch.core as tcore
        import repro_torch.core.csd as tcsd
        import repro_torch.core.energy as tenergy
        import repro_torch.core.qsq as tqsq
        import repro_torch.models.cnn as tcnn
        yield


def _weights(n=200_000, seed=0):
    """Trained-weight-like values plus the edge cases: zero, exact powers
    of two and their 1.5x boundaries, values under 2^-17, large values."""
    w = (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)
    w[:12] = [0.0, 1.5, 0.75, 2.0**-17, -2.0**-17, 3.0, -1.5, 1e-8, 7.9, -0.375, 2.0**14,
              -40000.0]
    return w


def test_eq11_eq12_and_energy_exact():
    for numel, g, be in ((6 * 5 * 5, 16, 3), (120 * 400, 16, 2), (10_000_000, 64, 3), (48, 1, 3)):
        assert tenergy.nbits_unquantized(numel) == jenergy.nbits_unquantized(numel)
        assert tenergy.nbits_quantized(numel, g, be) == jenergy.nbits_quantized(numel, g, be)
        assert tenergy.memory_savings(numel, g, be) == jenergy.memory_savings(numel, g, be)
        assert tenergy.energy_savings(numel, g, be) == jenergy.energy_savings(numel, g, be)
        assert tenergy.dram_energy_pj(numel) == jenergy.dram_energy_pj(numel)
    for args in ((5, 5, 6, 16), (3, 3, 64, 64)):
        for g in (None, 8, 16):
            assert tenergy.nbits_conv_layer(*args, group_size=g) == jenergy.nbits_conv_layer(
                *args, group_size=g)
    assert (tenergy.DRAM_PJ_PER_32B_ACCESS, tenergy.FPB) == (6400.0, 32)
    for name in ("LENET", "CONVNET4"):
        t_layers = tcnn.conv_layer_shapes(getattr(tcnn, name))
        j_layers = jcnn.conv_layer_shapes(getattr(jcnn, name))
        for g, be in ((16, 3), (8, 2)):
            assert tenergy.model_savings(t_layers, g, be) == jenergy.model_savings(j_layers, g, be)


def test_roofline_terms_with_explicit_constants():
    consts = (3.1e14, 2.2e12, 1.7e11)
    for flops, nbytes, coll, chips in ((1e12, 1e9, 0.0, 1), (5e14, 2e11, 3e10, 4),
                                       (0.0, 0.0, 0.0, 1)):
        assert tenergy.roofline_terms(flops, nbytes, coll, chips, *consts) == \
            jenergy.roofline_terms(flops, nbytes, coll, chips, *consts)
    # the port's defaults are the H100's data-sheet figures, no TPU number
    assert (tenergy.H100_PEAK_BF16_FLOPS, tenergy.H100_HBM_BW, tenergy.H100_NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert not [n for n in vars(tenergy) if "TPU" in n]
    t = tenergy.roofline_terms(989e12, 3.35e12, 0.0, 1)
    assert t["compute_s"] == t["memory_s"] == 1.0


@pytest.mark.parametrize("frac_bits", [8, 16])
def test_csd_digit_count_and_histogram_bit_equal(frac_bits):
    w = _weights()
    j = np.asarray(jcsd.csd_digit_count(jnp.asarray(w), frac_bits=frac_bits))
    t = tcsd.csd_digit_count(torch.from_numpy(w), frac_bits=frac_bits)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(
        tcsd.csd_nonzero_histogram(torch.from_numpy(w), frac_bits=frac_bits).numpy(),
        np.asarray(jcsd.csd_nonzero_histogram(jnp.asarray(w), frac_bits=frac_bits)))
    u = np.random.default_rng(1).integers(0, 2**32, size=20_000, dtype=np.uint64)
    np.testing.assert_array_equal(
        tcsd._popcount32(torch.from_numpy(u.astype(np.int64))).numpy(),
        np.asarray(jcsd._popcount32(jnp.asarray(u.astype(np.uint32)))))


def _on_boundary(w, k, min_exp=-16, max_exp=15):
    """True where one of the first ``k`` residuals of ``csd_round``'s digit
    loop (the port's, step by step) lies within one f32 ulp of 2^e,
    1.5 * 2^e or the cut-off 2^(min_exp - 1)."""
    r = torch.from_numpy(w)
    hit = np.zeros(len(w), bool)
    for _ in range(k):
        a = torch.abs(r)
        an = a.numpy().astype(np.float64)
        e = np.floor(np.log2(np.where(an > 0, an, 1.0)))
        ulp = np.spacing(a.numpy()).astype(np.float64)
        for c in (2.0**e, 2.0 ** (e + 1), 1.5 * 2.0**e, np.full_like(an, 2.0 ** (min_exp - 1))):
            hit |= (an > 0) & (np.abs(an - c) <= ulp)
        safe = torch.where(a > 0, a, torch.ones_like(a))
        ex = torch.clamp(torch.floor(torch.log2(safe * (4.0 / 3.0))), min_exp, max_exp)
        term = torch.where(a > 2.0 ** (min_exp - 1), torch.sign(r) * torch.exp2(ex),
                           torch.zeros_like(r))
        r = r - term
    return hit


@pytest.mark.parametrize("k", [1, 2, 3])
def test_csd_round_equal_outside_counted_boundaries(k):
    w = _weights()
    j = np.asarray(jcsd.csd_round(jnp.asarray(w), k)).astype(np.float64)
    t = tcsd.csd_round(torch.from_numpy(w), k).numpy().astype(np.float64)
    off = np.abs(t - j) > 1e-6 * np.abs(w)
    assert off.sum() <= len(w) // 10_000, off.sum()
    # every element that differs sits on a boundary of the digit loop
    assert _on_boundary(w, k)[off].all(), np.nonzero(off & ~_on_boundary(w, k))[0]
    # zero and values below the cut-off round to 0 in both
    np.testing.assert_array_equal(t[[0, 7]], 0.0)
    np.testing.assert_array_equal(j[[0, 7]], 0.0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_partial_product_savings_close(k):
    w = _weights()
    t = float(tcsd.partial_product_savings(torch.from_numpy(w), k))
    assert t == pytest.approx(float(jcsd.partial_product_savings(jnp.asarray(w), k)), abs=1e-6)
    assert 0.0 < t < 1.0
    assert float(tcsd.partial_product_savings(torch.zeros(8), k)) == 0.0


def test_qsq_helpers_match_jax():
    for phi in (1, 2, 4):
        np.testing.assert_array_equal(tqsq.levels_for_phi(phi), jqsq.levels_for_phi(phi))
    np.testing.assert_array_equal(tcore.LEVEL_TABLE, jqsq.LEVEL_TABLE)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    w[rng.random(w.shape) < 0.1] = 0.0
    assert float(tqsq.zeros_fraction(torch.from_numpy(w))) == pytest.approx(
        float(jqsq.zeros_fraction(jnp.asarray(w))), rel=1e-6)
    for cfg in (dict(phi=4), dict(phi=2, assign="sigma"), dict(phi=1, refit_alpha=True)):
        jq = jqsq.quantize(jnp.asarray(w), jqsq.QSQConfig(group_size=16, **cfg))
        tq = tqsq.quantize(torch.from_numpy(w), tqsq.QSQConfig(group_size=16, **cfg))
        np.testing.assert_array_equal(tq.codes().numpy(), np.asarray(jq.codes()))
        assert tq.nbits() == jq.nbits() and tq.shape == tuple(jq.shape)
        np.testing.assert_allclose(float(tqsq.quantization_error(torch.from_numpy(w), tq)),
                                   float(jqsq.quantization_error(jnp.asarray(w), jq)),
                                   rtol=1e-5)


def test_exhaustive_threshold_search_picks_the_same_thresholds():
    w = np.random.default_rng(3).standard_normal((128, 16)).astype(np.float32)
    grid = dict(deltas=(1.5, 2.5), gamma_fracs=(0.25, 0.75))
    j = jqsq.exhaustive_threshold_search(jnp.asarray(w), jqsq.QSQConfig(phi=4), **grid)
    t = tqsq.exhaustive_threshold_search(torch.from_numpy(w), tqsq.QSQConfig(phi=4), **grid)
    assert t.assign == "sigma"
    assert (t.delta, t.gamma_frac) == (j.delta, j.gamma_frac)
