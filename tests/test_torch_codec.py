"""Parity of the port's codec, code tables and quantizer with the JAX package.

The same codes and weights, made with numpy from a seed, go through
``repro.core`` and ``repro_torch.core``.  Packing, unpacking, layout
changes, code tables and per-plane CRCs are bit-exact; the quantizer's
scales agree to rtol 1e-6 (two different f32 summation orders) and its
codes are equal except at reported near-ties of the nearest-level rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from torch_port_scope import port_modules

from repro.core import codec as jcodec
from repro.core import qsq as jqsq

SHAPES = [(32, 1), (64, 5), (96, 3, 4), (256, 17)]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tcodec, tqsq
    with port_modules():
        from repro_torch.core import codec as tcodec
        from repro_torch.core import qsq as tqsq
        yield


def _codes(shape, seed=0, hi=8):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(np.uint8)


def test_bitplane_pack_unpack_bit_exact():
    for shape in SHAPES:
        c = _codes(shape)
        jp = np.asarray(jcodec.pack_bitplane(jnp.asarray(c)))
        tp = tcodec.pack_bitplane(torch.from_numpy(c))
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert tp.dtype == torch.int32
        np.testing.assert_array_equal(tcodec.unpack_bitplane(tp).numpy(), c)


@pytest.mark.parametrize("shape", SHAPES)
def test_plane_major_bit_exact(shape):
    c = _codes(shape, seed=1)
    jp = jcodec.pack_bitplane(jnp.asarray(c))
    jpm = np.asarray(jcodec.plane_major(jp))
    tpm = tcodec.plane_major(tcodec.pack_bitplane(torch.from_numpy(c)))
    np.testing.assert_array_equal(tpm.numpy(), jpm)
    for n_planes in (1, 2, 3):
        np.testing.assert_array_equal(
            tcodec.unpack_bitplane_major(tpm, n_planes=n_planes).numpy(),
            np.asarray(jcodec.unpack_bitplane_major(jnp.asarray(jpm), n_planes=n_planes)))
    np.testing.assert_array_equal(tcodec.plane_interleaved(tpm).numpy(), np.asarray(jp))


@pytest.mark.parametrize("n", [1, 9, 10, 11, 1000])
def test_dense_wire_bit_exact(n):
    for bits in (2, 3):
        c = _codes((n,), seed=n, hi=1 << bits)
        jw = np.asarray(jcodec.pack_dense(jnp.asarray(c), bits=bits))
        tw = tcodec.pack_dense(torch.from_numpy(c), bits=bits)
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tcodec.unpack_dense(tw, n, bits=bits).numpy(), c)
        np.testing.assert_array_equal(
            tcodec.unpack_dense(torch.from_numpy(np.array(jw)), n, bits=bits).numpy(),
            np.asarray(jcodec.unpack_dense(jnp.asarray(jw), n, bits=bits)))


def test_wire_bytes_matches_jax():
    for n_codes in (0, 1, 10, 11, 1000, 576 * 49152):
        for n_scales in (0, 1, n_codes // 16):
            for bits in (2, 3):
                for scalar_bits in (16, 32):
                    assert tcodec.wire_bytes(n_codes, n_scales, bits, scalar_bits) == \
                        jcodec.wire_bytes(n_codes, n_scales, bits, scalar_bits)
    assert tcodec.wire_bytes(10, 1) == 4 + 4


def test_plane_crcs_equal():
    for shape in SHAPES:
        c = _codes(shape, seed=2)
        assert tcodec.plane_crcs(torch.from_numpy(c)) == jcodec.plane_crcs(c)


def test_code_tables_bit_exact():
    codes = np.arange(256, dtype=np.uint8)  # stray high bits are dropped
    np.testing.assert_array_equal(
        tqsq.codes_to_levels(torch.from_numpy(codes)).numpy(),
        np.asarray(jqsq.codes_to_levels(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        tqsq.smcodes_to_levels(torch.from_numpy(codes)).numpy(),
        np.asarray(jqsq.smcodes_to_levels(jnp.asarray(codes))))
    levels = np.array([0, 1, 2, 4, -1, -2, -4], dtype=np.int8)
    np.testing.assert_array_equal(
        tqsq.levels_to_codes(torch.from_numpy(levels)).numpy(),
        np.asarray(jqsq.levels_to_codes(jnp.asarray(levels))))
    np.testing.assert_array_equal(
        tqsq.levels_to_smcodes(torch.from_numpy(levels)).numpy(),
        np.asarray(jqsq.levels_to_smcodes(jnp.asarray(levels))))


def _near_tie(w, alpha, g, tol=1e-5):
    """|w/alpha| within ``tol`` (relative) of a nearest-level boundary."""
    r = np.abs(w.reshape(w.shape[0] // g, g, *w.shape[1:])
               / np.where(alpha == 0, 1, alpha)[:, None])
    return np.any([np.abs(r - b) <= tol * b for b in (0.5, 1.5, 3.0)], axis=0).reshape(w.shape)


@pytest.mark.parametrize("phi", [1, 2, 4])
@pytest.mark.parametrize("refit", [True, False])
def test_quantize_matches_jax(phi, refit):
    for group_size in (16, 32):
        w = np.random.default_rng(phi * 7 + group_size).standard_normal((128, 48)).astype(
            np.float32)
        jq = jqsq.quantize(jnp.asarray(w), jqsq.QSQConfig(phi=phi, group_size=group_size,
                                                           refit_alpha=refit))
        tq = tqsq.quantize(torch.from_numpy(w), tqsq.QSQConfig(
            phi=phi, group_size=group_size, refit_alpha=refit))
        js, ts = np.asarray(jq.scales), tq.scales.numpy()
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
        diff = np.asarray(jq.levels) != tq.levels.numpy()
        ties = _near_tie(w, js, group_size)
        assert not np.any(diff & ~ties), f"{int(diff.sum())} codes differ off near-ties"


def test_quantize_stacked_axis_matches_per_layer():
    """Grouping along axis 1 of a stacked (L, K, N) leaf equals quantizing
    each layer alone (the JAX package vmaps over the stack)."""
    w = np.random.default_rng(3).standard_normal((3, 64, 20)).astype(np.float32)
    lev, sc = tqsq._quantize_impl(torch.from_numpy(w), phi=4, group_size=16,
                                  assign="nearest", delta=2.0, gamma_frac=0.5,
                                  refit_alpha=True, axis=1)
    for i in range(3):
        q = tqsq.quantize(torch.from_numpy(w[i]), tqsq.QSQConfig(refit_alpha=True))
        np.testing.assert_array_equal(lev[i].numpy(), q.levels.numpy())
        np.testing.assert_array_equal(sc[i].numpy(), q.scales.numpy())


def test_quantize_sigma_assign_matches_jax():
    w = np.random.default_rng(5).standard_normal((64, 24)).astype(np.float32)
    cfg = dict(phi=4, group_size=16, assign="sigma")
    jq = jqsq.quantize(jnp.asarray(w), jqsq.QSQConfig(**cfg))
    tq = tqsq.quantize(torch.from_numpy(w), tqsq.QSQConfig(**cfg))
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales), rtol=1e-6)
    np.testing.assert_array_equal(tq.levels.numpy(), np.asarray(jq.levels))
