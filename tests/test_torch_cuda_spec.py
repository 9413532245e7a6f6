"""Speculative and static serving on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; the
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_spec.py

It checks: every row of a verify window through K4/K3 (M = slots x
(k + 1), up to 64) equals the decode row of the same x through K2/K1
(M = slots) bit for bit, bf16 and f32 x, every demand; and, on a small
bf16 model compressed on the card, that speculative streams (a lossy
draft tier and the echo ladder) give the tokens of plain decode, that the
static greedy path runs K1 and K3, and that sampling is reproducible from
a seed.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

pytestmark = pytest.mark.cuda

SHAPES = [(576, 576), (576, 192), (1536, 576), (64, 1000), (96, 48)]  # (K, N)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global api, ArchConfig, Model, init_params, qsq, MASK_VARIANTS
    with port_modules():
        from repro_torch import api
        from repro_torch.configs.base import ArchConfig
        from repro_torch.kernels import qsq
        from repro_torch.kernels.ref import MASK_VARIANTS
        from repro_torch.models.api import Model
        from repro_torch.models.base import init_params
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("slots,w", [(8, 5), (4, 3), (8, 8), (2, 9)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_verify_rows_equal_decode_rows(cuda, slots, w, dtype):
    gen = torch.Generator(device="cuda").manual_seed(slots * 10 + w)
    dt = getattr(torch, dtype)
    for k, n in SHAPES:
        m = slots * w
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        planes = torch.randint(-2**31, 2**31 - 1, (3, k // 32, n), generator=gen,
                               device="cuda", dtype=torch.int32)
        scales = torch.rand((k // 16, n), generator=gen, device="cuda") * 0.09 + 0.01
        for demand in (0, 1, 2):
            pool = torch.tensor(MASK_VARIANTS[demand:], dtype=torch.int32, device="cuda")
            lane = pool[torch.randint(0, len(pool), (slots,), generator=gen, device="cuda")]
            kw = dict(group_size=16, sign_mag=True, plane_major=True, demand_drop=demand)
            big = qsq.qsq_matmul_masked if m > qsq.GEMV_M_MAX else qsq.qsq_matvec_masked
            win_m = big(x, lane.repeat_interleave(w).contiguous(), planes, scales, **kw)
            big = qsq.qsq_matmul if m > qsq.GEMV_M_MAX else qsq.qsq_matvec
            win = big(x, planes, scales, group_size=16, sign_mag=True, plane_major=True)
            for j in range(w):
                xj = x[j::w].contiguous()
                assert torch.equal(win_m[j::w], qsq.qsq_matvec_masked(xj, lane, planes,
                                                                      scales, **kw))
                assert torch.equal(win[j::w], qsq.qsq_matvec(xj, planes, scales, group_size=16,
                                                             sign_mag=True, plane_major=True))


@pytest.fixture(scope="module")
def artifact():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv=2,
                     d_ff=256, vocab=512, dtype=torch.bfloat16, remat=False)
    model = Model(cfg)
    params = init_params(model.param_descs(), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tiers = api.QualitySpec((api.QualityTier("hi", 0, 0.0), api.QualityTier("mid", 1, 0.5),
                             api.QualityTier("lo", 2, 0.75)))
    return api.compress(model, params, tiers=tiers, device="cuda")


PROMPTS = [[5, 9, 2], [17], [3, 3, 3, 3, 8, 1], [250, 1], [7] * 8, [1, 2, 3, 4], [9] * 5,
           [400, 2]]


def _stream(eng, speculate, quals):
    eng.reset_stream()
    rids = [eng.submit(p, max_new=12, quality=q, speculate=speculate if i % 2 == 0 else None)
            for i, (p, q) in enumerate(zip(PROMPTS, quals, strict=True))]
    done = eng.run_until_drained()
    return [done[r].tokens for r in rids]


def test_speculative_tokens_equal_plain_decode(cuda, artifact):
    eng = artifact.engine(quality="hi", batch_slots=4, max_prompt=8, max_len=32)
    quals = ["hi", "mid"] * 4
    qsq.reset_launches()
    spec = _stream(eng, api.SpecConfig("lo", k=4), quals)
    stats = eng.stream_stats()
    assert qsq.launches["qsq_matmul_masked"] > 0 and qsq.launches["qsq_matvec_masked"] > 0
    assert spec == _stream(eng, None, quals)
    assert stats["drafted"] > 0


def test_echo_ladder_accepts_every_draft(cuda, artifact):
    echo = api.EdgeArtifact(wire=artifact.wire, arch_config=artifact.arch_config,
                            tiers=api.QualitySpec((api.QualityTier("hi", 0, 0.0),
                                                   api.QualityTier("echo", 0, 0.0))),
                            rank=artifact.rank)
    eng = echo.engine(quality="hi", batch_slots=8, max_prompt=8, max_len=32)
    spec = _stream(eng, api.SpecConfig("echo", k=3), ["hi"] * 8)
    stats = eng.stream_stats()
    assert stats["drafted"] > 0 and stats["acceptance_rate"] == 1.0
    assert spec == _stream(eng, None, ["hi"] * 8)


def test_static_path_launches_k1_k3_and_samples_reproducibly(cuda, artifact):
    st = artifact.engine(quality="mid", continuous=False, batch_slots=8)
    qsq.reset_launches()
    toks = st.generate(PROMPTS, max_new=6)
    assert qsq.launches["qsq_matvec"] > 0 and qsq.launches["qsq_matmul"] > 0
    assert all(len(t) == 6 for t in toks)
    hot = artifact.engine(quality="mid", temperature=0.8, batch_slots=8)
    assert hot.generate(PROMPTS, max_new=6, seed=5) == hot.generate(PROMPTS, max_new=6, seed=5)
