"""The split-K tensor-core packed matmuls (K1-K4, ``csrc/qsq_mma.cuh``) at
their edges, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; the
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py tests/test_torch_cuda_packed.py

At edge shapes — N below one 32-column block, N not a multiple of 4 or of
the block, K of one word, K words not divisible by the split, M of 1, 8
and 16 for the GEMV and 17, 64, 65 and 200 for the GEMM, G in {16, 32, 64},
bf16 and f32 x, plane-major sign-magnitude and interleaved Table II
planes — it checks: elementwise agreement with the plain version within
2*K*2^-24*(|x|@|w|); masked rows bit-identical to the unmasked kernel on
planes truncated to the row's drop; demand routing bit-identical to the
full masked output, with undemanded rows exactly zero; two calls giving
the same bits; and one kernel launch per call.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

pytestmark = pytest.mark.cuda

# (M, K, N, G): K = 224 is 7 words, which no split of the plans divides
GEMV_CASES = [(1, 32, 8, 16), (8, 224, 30, 32), (16, 576, 100, 64), (8, 1536, 576, 16),
              (5, 96, 1000, 32)]
GEMM_CASES = [(17, 32, 8, 16), (64, 224, 30, 32), (65, 576, 100, 64), (200, 1536, 200, 16)]
LAYOUTS = [(True, True), (False, False)]  # (sign_mag, plane_major)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global qsq, ref, MASK_VARIANTS
    with port_modules():
        from repro_torch.kernels import qsq, ref
        from repro_torch.kernels.ref import MASK_VARIANTS
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(m, k, n, g, seed, dtype, plane_major, masks):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    shape = (3, k // 32, n) if plane_major else (k // 32, 3, n)
    planes = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda",
                           dtype=torch.int32)
    scales = torch.rand((k // g, n), generator=gen, device="cuda") * 0.09 + 0.01
    pool = torch.tensor(masks, dtype=torch.int32, device="cuda")
    mask = pool[torch.randint(0, len(masks), (m,), generator=gen, device="cuda")]
    return x, planes, scales, mask.contiguous()


def _truncate(planes, drop, plane_major):
    """Planes with the ``drop`` low code bits cleared."""
    out = planes.clone()
    if drop:
        if plane_major:
            out[3 - drop:] = 0  # MSB first
        else:
            out[:, :drop] = 0  # bit b at index b
    return out


def _bound(x, mask, planes, scales, g, kw, demand):
    xs = ref.variant_split(x.float().abs(), mask, demand)
    out = 0
    for i, code_mask in enumerate(MASK_VARIANTS[demand:]):
        w = ref.qsq_dequant_ref(planes, scales, g, sign_mag=kw["sign_mag"],
                                plane_major=kw["plane_major"], n_planes=3 - demand,
                                code_mask=code_mask)
        out = out + xs[i].double() @ w.to(x.dtype).float().abs().double()
    return 2 * x.shape[1] * 2.0**-24 * out


def _check_case(kind, m, k, n, g, seed):
    masked = getattr(qsq, f"qsq_{kind}_masked")
    unmasked = getattr(qsq, f"qsq_{kind}")
    for dtype in (torch.bfloat16, torch.float32):
        for sign_mag, plane_major in LAYOUTS:
            x, planes, scales, mask = _operands(m, k, n, g, seed, dtype, plane_major,
                                                MASK_VARIANTS)
            kw = dict(group_size=g, sign_mag=sign_mag, plane_major=plane_major)
            got = masked(x, mask, planes, scales, **kw)
            torch.cuda.synchronize()
            want = ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw)
            err = (got.double() - want.double()).abs()
            assert bool(torch.isfinite(got).all())
            assert bool((err <= _bound(x, mask, planes, scales, g, kw, 0)).all()), \
                f"{kind} {dtype} {kw}: max err {float(err.max()):.3e} beyond the f32 bound"
            for drop, code_mask in enumerate(MASK_VARIANTS):
                rows = mask == code_mask
                base = unmasked(x, _truncate(planes, drop, plane_major), scales, **kw)
                assert torch.equal(got[rows], base[rows]), \
                    f"{kind} {dtype} {kw}: drop-{drop} rows differ from truncated planes"
            for demand in (1, 2):
                live = torch.tensor(MASK_VARIANTS[demand:], dtype=torch.int32, device="cuda")
                dmask = live[torch.arange(m, device="cuda") % len(live)].contiguous()
                full = masked(x, dmask, planes, scales, demand_drop=0, **kw)
                routed = masked(x, dmask, planes, scales, demand_drop=demand, **kw)
                assert torch.equal(routed, full), f"{kind} {dtype} {kw}: demand {demand}"
                if plane_major:  # the unmasked kernel reads 3 - demand planes
                    short = unmasked(x, planes, scales, demand_drop=demand, **kw)
                    assert torch.equal(short, unmasked(
                        x, _truncate(planes, demand, True), scales, **kw))


@pytest.mark.parametrize("m,k,n,g", GEMV_CASES)
def test_gemv_edges(cuda, m, k, n, g):
    _check_case("matvec", m, k, n, g, seed=m + k + n)


@pytest.mark.parametrize("m,k,n,g", GEMM_CASES)
def test_gemm_edges(cuda, m, k, n, g):
    _check_case("matmul", m, k, n, g, seed=m + k + n)


@pytest.mark.parametrize("kind,m", [("matvec", 16), ("matmul", 65)])
def test_undemanded_and_unknown_rows_are_zero(cuda, kind, m):
    fn = getattr(qsq, f"qsq_{kind}_masked")
    masks = MASK_VARIANTS + (0b101, 0b011)  # two masks no variant matches
    x, planes, scales, mask = _operands(m, 576, 200, 16, 4, torch.bfloat16, True, masks)
    kw = dict(group_size=16, sign_mag=True, plane_major=True)
    for demand in (0, 1, 2):
        got = fn(x, mask, planes, scales, demand_drop=demand, **kw)
        dead = ~torch.isin(mask, torch.tensor(MASK_VARIANTS[demand:], device="cuda"))
        assert bool(dead.any()) and bool((got[dead] == 0).all())
        # sign-magnitude codes under 0b100 keep only the sign: all-zero rows
        alive = ~dead & (mask != MASK_VARIANTS[2])
        assert not bool((got[alive] == 0).all(dim=1).any())
        want = ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, demand_drop=demand, **kw)
        assert torch.equal(got[dead], want[dead])


@pytest.mark.parametrize("name,m,k,n", [("qsq_matvec_masked", 8, 1536, 576),
                                        ("qsq_matvec", 8, 576, 49152),
                                        ("qsq_matmul_masked", 64, 576, 1536),
                                        ("qsq_matmul", 64, 1536, 576)])
def test_two_calls_same_bits(cuda, name, m, k, n):
    masked = name.endswith("_masked")
    x, planes, scales, mask = _operands(m, k, n, 16, 6, torch.bfloat16, True, MASK_VARIANTS)
    kw = dict(group_size=16, sign_mag=True, plane_major=True)
    fn = getattr(qsq, name)
    outs = [fn(x, mask, planes, scales, **kw) if masked else fn(x, planes, scales, **kw)
            for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def test_one_launch_per_call(cuda):
    """Each wrapper call is one kernel on the card, whatever its split."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = dict(group_size=16, sign_mag=True, plane_major=True)
    for name, m, k, n in [("qsq_matvec", 8, 1536, 576), ("qsq_matvec_masked", 8, 576, 192),
                          ("qsq_matmul", 64, 576, 49152), ("qsq_matmul_masked", 64, 1536, 576)]:
        x, planes, scales, mask = _operands(m, k, n, 16, 7, torch.bfloat16, True,
                                            MASK_VARIANTS)
        fn = getattr(qsq, name)
        call = (lambda: fn(x, mask, planes, scales, **kw)) if name.endswith("_masked") \
            else (lambda: fn(x, planes, scales, **kw))
        call()
        torch.cuda.synchronize()
        before = qsq.launches[name]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        assert sum(e.count for e in kernels) == 1, [(e.key, e.count) for e in kernels]
        assert qsq.launches[name] == before + 1
