"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode; the CPU tests hold the plain versions against
the JAX package instead).  The file imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Checks, at smollm-135m's packed shapes: elementwise agreement within the
a-priori bound of two f32 summation orders, 2*K*2^-24*(|x|@|w|); masked
rows bit-identical to the unmasked kernel on truncated planes;
demand-routed output bit-identical to the full masked one; and the
launch counter moving once per launch.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

pytestmark = pytest.mark.cuda

G = 16


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


def _operands(m, k, n, seed, dtype, min_drop=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    planes = torch.randint(-2**31, 2**31 - 1, (3, k // 32, n), generator=gen,
                           device="cuda", dtype=torch.int32)
    scales = torch.rand((k // G, n), generator=gen, device="cuda") * 0.09 + 0.01
    variants = torch.tensor(MASK_VARIANTS[min_drop:], dtype=torch.int32, device="cuda")
    mask = variants[torch.randint(0, len(variants), (m,), generator=gen, device="cuda")]
    return x, planes, scales, mask.contiguous()


def _bound(x, mask, planes, scales, demand):
    xs = ref.variant_split(x.float().abs(), mask, demand)
    out = 0
    for i, code_mask in enumerate(MASK_VARIANTS[demand:]):
        w = ref.qsq_dequant_ref(planes, scales, G, sign_mag=True, plane_major=True,
                                n_planes=3 - demand, code_mask=code_mask)
        out = out + xs[i].double() @ w.to(x.dtype).float().abs().double()
    return 2 * x.shape[1] * 2.0**-24 * out


KERNELS = [("qsq_matvec", False, 8), ("qsq_matvec_masked", True, 8),
           ("qsq_matmul", False, 64), ("qsq_matmul_masked", True, 64)]


@pytest.mark.parametrize("name,masked,m", KERNELS)
@pytest.mark.parametrize("k,n", [(576, 192), (1536, 576), (576, 1000)])
def test_kernel_within_f32_bound_of_plain(cuda, name, masked, m, k, n):
    for dtype in ("float32", "bfloat16"):
        for demand in (0, 1, 2):
            _check_within_bound(cuda, name, masked, m, k, n, dtype, demand)


def _check_within_bound(cuda, name, masked, m, k, n, dtype, demand):
    x, planes, scales, mask = _operands(m, k, n, k + n + demand, getattr(torch, dtype),
                                        demand)
    if not masked:
        mask = torch.full((m,), MASK_VARIANTS[demand], dtype=torch.int32, device=cuda)
    kw = dict(group_size=G, sign_mag=True, plane_major=True, demand_drop=demand)
    fn = getattr(qsq, name)
    before = qsq.launches[name]
    got = fn(x, mask, planes, scales, **kw) if masked else fn(x, planes, scales, **kw)
    torch.cuda.synchronize()
    assert qsq.launches[name] == before + 1
    want = ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw)
    err = (got.double() - want.double()).abs()
    assert bool((err <= _bound(x, mask, planes, scales, demand)).all())


@pytest.mark.parametrize("name,m", [("qsq_matvec_masked", 5), ("qsq_matmul_masked", 37)])
def test_masked_rows_bit_identical_to_truncated(cuda, name, m):
    unmasked = getattr(qsq, name.replace("_masked", ""))
    for dtype in (torch.float32, torch.bfloat16):
        x, planes, scales, mask = _operands(m, 576, 200, 3, dtype)
        got = getattr(qsq, name)(x, mask, planes, scales, group_size=G, sign_mag=True,
                                 plane_major=True)
        for drop, code_mask in enumerate(MASK_VARIANTS):
            rows = mask == code_mask
            trunc = planes.clone()
            trunc[3 - drop:] = 0
            base = unmasked(x, trunc, scales, group_size=G, sign_mag=True, plane_major=True)
            assert torch.equal(got[rows], base[rows])


@pytest.mark.parametrize("name,m", [("qsq_matvec_masked", 16), ("qsq_matmul_masked", 64)])
@pytest.mark.parametrize("demand", [1, 2])
def test_demand_routed_bit_identical_to_masked(cuda, name, m, demand):
    x, planes, scales, mask = _operands(m, 1536, 576, 9, torch.bfloat16, demand)
    fn = getattr(qsq, name)
    kw = dict(group_size=G, sign_mag=True, plane_major=True)
    assert torch.equal(fn(x, mask, planes, scales, demand_drop=demand, **kw),
                       fn(x, mask, planes, scales, demand_drop=0, **kw))


@pytest.mark.parametrize("layout", ["interleaved", "table2"])
def test_other_layouts_and_codes(cuda, layout):
    x, planes, scales, mask = _operands(12, 256, 96, 5, torch.float32)
    sign_mag = layout != "table2"
    plane_major = layout == "table2"
    if not plane_major:
        planes = torch.flip(planes, dims=(0,)).movedim(0, 1).contiguous()
    kw = dict(group_size=G, sign_mag=sign_mag, plane_major=plane_major)
    got = qsq.qsq_matvec_masked(x, mask, planes, scales, **kw)
    want = ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_raises_on_unsupported_operands(cuda):
    x, planes, scales, _ = _operands(17, 64, 32, 0, torch.float32)
    with pytest.raises(ValueError, match="M <= 16"):
        qsq.qsq_matvec(x, planes, scales, group_size=G, plane_major=True)
    with pytest.raises(TypeError):
        qsq.qsq_matmul(x.half(), planes, scales, group_size=G, plane_major=True)
    with pytest.raises(ValueError, match="different devices"):
        qsq.qsq_matmul(x.cpu(), planes, scales, group_size=G, plane_major=True)
