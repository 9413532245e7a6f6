"""The launch plan of the split-K packed matmuls (``kernels.qsq.launch_plan``).

The CUDA kernels (``csrc/qsq_mma.cuh``) run only on a card, but how a call
is cut over the card is decided in Python, so its invariants are checked
here: every 32-code word lands in exactly one K slice, slice bounds fall on
word multiples, the plan is a function of (kind, M, K, N, G, x dtype) alone
(never of ``demand_drop`` or the masks, which keeps masked rows
bit-identical to the unmasked kernel on truncated planes), clusters stay
within the portable 8 blocks, the grid covers N, a block's shared memory
fits, and the smollm-135m serving shapes put work on the card's 132 SMs.
With bf16 x and G a multiple of 16, no packed shape of the four dense
configs falls back to the FMA kernel.
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

SMOLLM = [(576, 576), (576, 192), (576, 1536), (1536, 576), (576, 49152)]  # (K, N)
EDGES = [(32, 8), (224, 30), (96, 1000), (576, 100), (1536, 200), (4096, 4096), (16384, 64)]
KINDS = [("gemv", 1), ("gemv", 8), ("gemv", 16), ("gemm", 17), ("gemm", 64), ("gemm", 65),
         ("gemm", 200)]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global qsq
    with port_modules():
        from repro_torch.kernels import qsq
        yield


def _plans(groups=(16, 32, 64)):
    for kind, m in KINDS:
        for k, n in SMOLLM + EDGES:
            for g in groups:
                if k % g == 0:
                    yield kind, m, k, n, g, qsq.launch_plan(kind, m, k, n, g, torch.bfloat16)


def test_every_word_in_exactly_one_slice():
    for kind, m, k, n, g, p in _plans():
        if p.route != "mma":
            continue
        slices = p.k_slices(k)
        assert len(slices) == p.cs * p.wk
        assert slices[0][0] == 0 and slices[-1][1] == k, (kind, m, k, n, p)
        for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
            assert hi == lo2  # contiguous, in reduction (K) order
        for lo, hi in slices:
            assert lo % 32 == 0 and hi % 32 == 0 and hi > lo, (kind, k, p, slices)
        words = [w for lo, hi in slices for w in range(lo // 32, hi // 32)]
        assert words == list(range(k // 32))


def test_slices_follow_the_kernel_formula():
    """slice s of S holds words [s*KW//S, (s+1)*KW//S), warp w of cluster rank
    r holding s = r*wk + w, as ``slice_lo`` in ``qsq_mma.cuh``."""
    p = qsq.LaunchPlan("mma", 1, 1, 2, 4, 4)
    kw, s = 1536 // 32, 16
    assert p.k_slices(1536) == [(32 * (i * kw // s), 32 * ((i + 1) * kw // s)) for i in range(s)]
    # 7 words over 4 slices: 1, 2, 2, 2
    assert qsq.LaunchPlan("mma", 1, 1, 1, 4, 1).k_slices(224) == [(0, 32), (32, 96), (96, 160),
                                                                  (160, 224)]


def test_plan_depends_only_on_shape_and_dtype():
    params = list(inspect.signature(qsq.launch_plan).parameters)
    assert params == ["kind", "m", "k", "n", "group_size", "x_dtype"]
    for kind, m, k, n, g, p in _plans(groups=(16,)):
        assert qsq.launch_plan(kind, m, k, n, g, torch.bfloat16) == p
    # the masked and unmasked wrappers of one kind share it, whatever the demand
    src = inspect.getsource(qsq._launch)
    assert 'launch_plan("gemv" if name.startswith("qsq_matvec") else "gemm"' in src
    assert "demand" not in src.split("launch_plan(")[1].split(")")[0]


def test_cluster_warps_and_tiles_within_limits():
    for kind, m, k, n, g, p in _plans():
        if p.route != "mma":
            continue
        assert 1 <= p.cs <= qsq.CLUSTER_MAX, p
        assert 1 <= p.wn * p.wk <= qsq.MAX_WARPS, p
        assert p.cs * p.wk <= k // 32, p  # no empty slice
        assert p.nt in (1, 2), p
        if kind == "gemv":
            assert p.mt == 1, p
        else:  # 64-row tiles wherever they fit the split, else the GEMV's 16-row tiles
            assert p.mt == 4 or p._replace(mt=4).smem_bytes(k) > qsq.SMEM_MAX, p
        if p.persist:
            assert p.cs == 1 and p.wk == 1, p


def test_grid_covers_n_and_m():
    for kind, m, k, n, g, p in _plans():
        if p.route != "mma":
            continue
        gx, gy = p.grid(m, n)
        tiles = gx // p.cs
        assert gx % p.cs == 0  # whole clusters along x
        assert (tiles - 1) * p.bn < n <= tiles * p.bn, (n, p)
        assert (gy - 1) * 16 * p.mt < m <= gy * 16 * p.mt, (m, p)


def test_shared_memory_fits():
    for kind, m, k, n, g, p in _plans():
        if p.route == "mma":
            assert p.smem_bytes(k) <= qsq.SMEM_MAX, (kind, m, k, n, p)


def test_smollm_serving_shapes_fill_the_card():
    """At least one block an SM; N = 192 has 24 eight-column groups and 4 K
    slices of 4 warps each, 96 blocks: splitting K further measured slower
    on the card (PERF.md)."""
    for kind, m in (("gemv", 8), ("gemm", 64)):
        for k, n in SMOLLM:
            p = qsq.launch_plan(kind, m, k, n, 16, torch.bfloat16)
            assert p.route == "mma"
            want = 96 if n == 192 else qsq.SMS
            assert p.blocks(m, n) >= want, (kind, k, n, p)
            assert p.persist == (n == 49152), p  # the head: a grid sized to the card


def test_fma_route_for_f32_x_and_other_groups():
    assert qsq.launch_plan("gemv", 8, 576, 576, 16, torch.float32).route == "fma"
    assert qsq.launch_plan("gemm", 64, 576, 576, 8, torch.bfloat16).route == "fma"
    assert qsq.launch_plan("gemm", 64, 576, 576, 48, torch.bfloat16).route == "mma"
    # the GEMM's 64 x rows over all of K do not fit even split 8 ways: it
    # runs on the GEMV's 16-row tiles, still on the tensor cores
    p = qsq.launch_plan("gemm", 64, 16384, 64, 16, torch.bfloat16)
    assert p.route == "mma" and p.mt == 1, p
    assert qsq.launch_plan("fma_kind_unused", 8, 64, 64, 16, torch.float32).blocks(8, 64) == 0


DENSE = {  # the packed (K, N) of every dense config the port serves: wq, wk/wv, wg/wu, wd, head
    "smollm_135m": SMOLLM,
    "phi4_mini_3_8b": [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 200064)],
    "qwen3_14b": [(5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120), (5120, 151936)],
    "deepseek_7b": [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 102400)],
    # mixtral-8x22b's packed leaves: wq, wk/wv, head (its experts serve dense)
    "mixtral_8x22b": [(6144, 6144), (6144, 1024), (6144, 32768)],
}


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_dense_config_shapes_take_tensor_cores(arch):
    """Every packed shape of the dense configs and of mixtral-8x22b's
    attention and head, G 16 and 64, M from a single decode row to a static
    prefill (mixtral's 4064-row admission too), takes the tensor-core route with
    a plan that fits; up to 64 rows the GEMM splits K as the GEMV does.
    (deepseek-7b's and qwen3-14b's ``wd`` took the FMA route at every M
    before the GEMM could fall back to 16-row tiles.)  The heads of the
    three large configs take the persistent GEMV."""
    for k, n in DENSE[arch]:
        for g in (16, 64):
            gemv = qsq.launch_plan("gemv", 8, k, n, g, torch.bfloat16)
            # mixtral's admission prefills its 4064-token window at once
            for m in (1, 8, 16, 40, 64, 128, 336) + ((4064,) if arch == "mixtral_8x22b" else ()):
                kind = "gemv" if m <= qsq.GEMV_M_MAX else "gemm"
                p = qsq.launch_plan(kind, m, k, n, g, torch.bfloat16)
                assert p.route == "mma", (arch, k, n, g, m, p)
                assert p.smem_bytes(k) <= qsq.SMEM_MAX, (arch, k, n, g, m, p)
                assert 1 <= p.cs <= qsq.CLUSTER_MAX and 1 <= p.wn * p.wk <= qsq.MAX_WARPS, p
                assert p.cs * p.wk <= k // 32, p
                gx, gy = p.grid(m, n)
                assert gx * p.bn >= n * p.cs and gy * 16 * p.mt >= m, (m, n, p)
                if m <= qsq.SAME_PLAN_ROWS:
                    assert p.k_slices(k) == gemv.k_slices(k), (arch, k, n, g, m)
                    assert (p.cs, p.wk) == (gemv.cs, gemv.wk), (arch, k, n, g, m)
        if arch != "smollm_135m" and n > 100000:
            assert qsq.launch_plan("gemv", 8, k, n, 16, torch.bfloat16).persist == 1
