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
launch counter moving once per launch.  The encoder (K5,
``qsq_quantize``) must equal its plain version bit for bit, codes and
scales, at every G the gradient compressor can pick, a ragged N, f32 and
bf16 input, and over a 30-layer stack grouped with G = 2.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

pytestmark = pytest.mark.cuda

G = 16


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global qsq, ref, MASK_VARIANTS, codec, pack_weight
    with port_modules():
        from repro_torch.core import codec
        from repro_torch.kernels import pack_weight, qsq, ref
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


def _quantize_pair(w, g, phi):
    before = qsq.launches["qsq_quantize"]
    codes, scales = qsq.qsq_quantize(w, group_size=g, phi=phi)
    torch.cuda.synchronize()
    assert qsq.launches["qsq_quantize"] == before + 1
    want_codes, want_scales = ref.qsq_quantize_ref(w, g, phi)
    assert codes.dtype == torch.uint8 and scales.dtype == torch.float32
    assert torch.equal(codes, want_codes)
    assert torch.equal(scales, want_scales)


def test_quantize_bit_identical_to_plain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for k, n in [(576, 1536), (256, 1000)]:  # N = 1000: a ragged last block
        w = torch.randn((k, n), generator=gen, device="cuda") * 1e-3
        w[:64, :5] = 0.0  # all-zero groups
        for g in (1, 2, 16, 32, 64, 24):  # 24: the runtime-G path
            if k % g:
                continue
            for phi in (1, 2, 4):
                for dtype in (torch.float32, torch.bfloat16):
                    _quantize_pair(w.to(dtype), g, phi)


def test_quantize_layer_stack_g2(cuda):
    """smollm-135m's mlp leaves: a (30, 884736) stack grouped along L."""
    w = torch.randn((30, 884736), generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    _quantize_pair(w, 2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        qsq.qsq_quantize(w, group_size=4)
    with pytest.raises(ValueError, match="contiguous"):
        qsq.qsq_quantize(w.t(), group_size=2)


def test_pack_weight_then_matmul_matches_plain_chain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn((576, 1536), generator=gen, device="cuda")
    x = torch.randn((64, 576), generator=gen, device="cuda")
    planes, scales = pack_weight(w, group_size=G)
    codes, want_scales = ref.qsq_quantize_ref(w, G, 4)
    assert torch.equal(planes, codec.pack_bitplane(codes)) and torch.equal(scales, want_scales)
    got = qsq.qsq_matmul(x, planes, scales, group_size=G)
    want = ref.qsq_matmul_ref(x, planes, scales, G)
    wd = ref.qsq_dequant_ref(planes, scales, G)
    bound = 2 * x.shape[1] * 2.0**-24 * (x.abs().double() @ wd.abs().double())
    assert bool(((got.double() - want.double()).abs() <= bound).all())
