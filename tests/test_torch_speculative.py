"""Self-speculative serving in the port against the JAX package.

* ``verify_attention`` and ``lm_verify``: outputs, the KV cache written in
  place and ``pos`` within 1e-5 / 1e-4 of the JAX functions, lanes with
  ``wlen == 0`` untouched;
* ``make_verify_step``: tokens, accepted counts and the rolled-back
  ``pos`` equal JAX's on crafted windows (full rejection, a partial
  prefix, the full window);
* the speculative fuzz streams of ``test_speculative.py`` (seeds 0-2) on
  one JAX-written artifact loaded by both packages: the port's tokens
  equal the JAX engine's and the port's plain decode;
* the cost clock (prefill + k draft ticks + ONE verify), submit
  validation, a mid-stream cancel, the echo ladder's full-window
  acceptance, and the phase-labelled per-call traffic equal to the
  engine's meter;
* ``serve_speculative`` on ``bench_serve._spec_model`` (trained by the
  JAX package, compressed and saved by it, loaded by the port): the port's
  ``stream_stats`` equal JAX's exactly (baseline: acceptance 1.0,
  13226.7 B per accepted token against 16640.0 for plain hi).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import api as japi
from repro.configs.base import ArchConfig as JArch
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.quant.artifact import QualitySpec as JSpec
from repro.quant.artifact import QualityTier as JTier
from repro.train.step import make_verify_step as jmake_verify_step

CFG = dict(name="smollm-like", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)
ENG = dict(max_prompt=8, max_len=32)
SPEC_TIERS = (("hi", 0, 0.0), ("mid", 1, 1.0), ("lo", 2, 1.0))
ECHO_TIERS = (("hi", 0, 0.0), ("echo", 0, 0.0))


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tdispatch, TKV, tlayers, tinit, tmake_verify_step, SAME_PLAN_ROWS, \
        launch_plan
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.kernels import dispatch as tdispatch
        from repro_torch.kernels.qsq import SAME_PLAN_ROWS, launch_plan
        from repro_torch.models import layers as tlayers
        from repro_torch.models.base import init_params as tinit
        from repro_torch.models.layers import KVCache as TKV
        from repro_torch.train.step import make_verify_step as tmake_verify_step
        yield


def _artifact_path(tmp_path_factory, tiers, name):
    model = JModel(JArch(**CFG, dtype=jnp.float32))
    params = jinit(jax.random.PRNGKey(0), model.param_descs())
    spec = JSpec(tuple(JTier(*t) for t in tiers))
    return japi.compress(model, params, tiers=spec).save(
        tmp_path_factory.mktemp(name) / "model.edge.npz")


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return _artifact_path(tmp_path_factory, SPEC_TIERS, "spec")


@pytest.fixture(scope="module")
def echo_path(tmp_path_factory):
    return _artifact_path(tmp_path_factory, ECHO_TIERS, "echo")


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# verify_attention / lm_verify / make_verify_step
# --------------------------------------------------------------------------
def test_verify_attention_matches_jax():
    rng = np.random.default_rng(0)
    b, t, w, d, h, kv, hd = 3, 12, 4, 64, 4, 2, 16
    p = {"wq": rng.standard_normal((d, h, hd)), "wk": rng.standard_normal((d, kv, hd)),
         "wv": rng.standard_normal((d, kv, hd)), "wo": rng.standard_normal((h, hd, d))}
    p = {k: (v * 0.1).astype(np.float32) for k, v in p.items()}
    k0 = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v0 = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    pos = np.array([7, 5, 3], np.int32)
    pad = np.array([1, 0, 2], np.int32)
    start = np.array([6, 5, 0], np.int32)
    wlen = np.array([4, 2, 0], np.int32)  # lane 2 is not verifying
    x = rng.standard_normal((b, w, d)).astype(np.float32)
    jy, jc = jlayers.verify_attention(
        {k: _j(v) for k, v in p.items()}, _j(x),
        jlayers.KVCache(k=_j(k0), v=_j(v0), pos=_j(pos), pad=_j(pad)),
        start=_j(start), wlen=_j(wlen))
    cache = TKV(k=_t(k0), v=_t(v0), pos=_t(pos), pad=_t(pad))
    ty, tc = tlayers.verify_attention({k: _t(v) for k, v in p.items()}, _t(x), cache,
                                      start=_t(start), wlen=_t(wlen))
    assert tc.k is cache.k and tc.v is cache.v, "the window is written in place"
    np.testing.assert_allclose(ty[:2].numpy(), np.asarray(jy)[:2], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tc.k[2].numpy(), k0[2])  # wlen 0: untouched
    np.testing.assert_array_equal(tc.k[1, 7:].numpy(), k0[1, 7:])  # past the window
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert tc.pos.tolist() == [10, 7, 3]


def _primed(path, prompts, tiers):
    """Both packages' served params and caches after one prefill of
    ``prompts`` (left-padded to 6) at per-lane ``tiers``."""
    toks = np.zeros((len(prompts), 6), np.int32)
    for i, p in enumerate(prompts):
        toks[i, 6 - len(p):] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    jart, tart = japi.load(path), tapi.load(path)
    jm, tm = jart.model(), tart.model()
    jp, _ = jart.serve_params("hi", per_request=True)
    tp, _ = tart.serve_params("hi", per_request=True, device="cpu")
    jc = jinit(jax.random.PRNGKey(0), jm.cache_descs(len(prompts), 16))
    tc = tinit(tm.cache_descs(len(prompts), 16), device="cpu")
    jc, jl = jm.prefill(jp, jc, _j(toks), _j(lens), _j(tiers), 0)
    tc, tl = tm.prefill(tp, tc, _t(toks), _t(lens), _t(tiers), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    return (jm, jp, jc, np.asarray(jnp.argmax(jl, -1))), (tm, tp, tc)


def test_lm_verify_matches_jax(spec_path):
    tiers = np.array([0, 1, 2], np.int32)
    (jm, jp, jc, first), (tm, tp, tc) = _primed(spec_path, [[5, 9, 2], [17], [3, 3, 8, 1]],
                                                 tiers)
    window = np.array([[first[0], 4, 8, 1], [first[1], 0, 0, 0], [first[2], 7, 7, 0]],
                      np.int32)
    start = np.full((3,), 6, np.int32)
    wlen = np.array([4, 0, 3], np.int32)
    spec = (wlen > 0).astype(np.int32)
    batch = dict(tokens=window, start=start, wlen=wlen, spec=spec, tiers=tiers)
    jlg, jc2 = jm.verify(jp, jc, {**{k: _j(v) for k, v in batch.items()}, "demand": 0})
    tlg, tc2 = tm.verify(tp, tc, {**{k: _t(v) for k, v in batch.items()}, "demand": 0})
    assert tlg.shape == (3, 4, CFG["vocab"]) and tlg.dtype == torch.float32
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4, rtol=1e-4)
    for a, b in ((tc2.kv.k, jc2.kv.k), (tc2.kv.v, jc2.kv.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc2.kv.pos.numpy(), np.asarray(jc2.kv.pos))
    assert tc2.kv.pos[:, 1].tolist() == [6, 6]  # the wlen-0 lane keeps its pos


def _greedy(jm, jp, jc, first, tiers, n):
    """The verify tier's own greedy continuation of every lane (JAX decode)."""
    cur = first[:, None].astype(np.int32)
    out = []
    for _ in range(n):
        lg, jc = jm.decode(jp, jc, {"tokens": _j(cur), "tiers": _j(tiers), "demand": 0})
        cur = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        out.append(cur[:, 0])
    return np.stack(out, 1)


@pytest.mark.parametrize("case,accept", [("reject", [0, 0]), ("partial", [2, 1]),
                                         ("full", [3, 3])])
def test_verify_step_matches_jax(spec_path, case, accept):
    tiers = np.array([0, 1], np.int32)
    prompts = [[5, 9, 2], [250, 1, 3]]
    (jm, jp, jc, first), (tm, tp, tc) = _primed(spec_path, prompts, tiers)
    g = _greedy(jm, jp, jc, first, tiers, 3)  # JAX caches are values: jc stays primed
    drafts = g.copy()
    for lane, a in enumerate(accept):
        if a < 3:
            drafts[lane, a] = (g[lane, a] + 1) % CFG["vocab"]  # the first wrong draft
    window = np.concatenate([first[:, None], drafts], 1).astype(np.int32)
    args = dict(window=window, start=np.full((2,), 6, np.int32),
                wlen=np.array([4, 4], np.int32), spec=np.ones((2,), np.int32))
    jt, ja, jc2 = jmake_verify_step(jm)(jp, jc, *(_j(v) for v in args.values()), _j(tiers), 0)
    tt, ta, tc2 = tmake_verify_step(tm)(tp, tc, *(_t(v) for v in args.values()), _t(tiers), 0)
    assert ta.tolist() == np.asarray(ja).tolist() == accept
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for lane, a in enumerate(accept):  # up to the first wrong draft: the verify tier's
        n = min(a + 1, g.shape[1])     # own greedy choices
        np.testing.assert_array_equal(tt[lane, :n].numpy(), g[lane, :n])
    np.testing.assert_array_equal(tc2.kv.pos.numpy(), np.asarray(jc2.kv.pos))
    assert tc2.kv.pos[0].tolist() == [6 + a + 1 for a in accept]


def test_one_tile_gemm_takes_the_gemv_split():
    """Up to ``SAME_PLAN_ROWS`` rows the GEMM's launch plan splits K as the
    GEMV's does (the card's verify rows equal its decode rows), here over
    K to 16384 and N from 48 to the smollm head."""
    assert SAME_PLAN_ROWS == 64
    for k in range(32, 16385, 96):
        for n in (48, 192, 576, 1536, 4096, 49152):
            for m, mm in ((1, 17), (8, 40), (16, SAME_PLAN_ROWS)):
                a = launch_plan("gemv", m, k, n, 16, torch.bfloat16)
                b = launch_plan("gemm", mm, k, n, 16, torch.bfloat16)
                assert (a.route, *a[2:]) == (b.route, *b[2:]), (k, n, m, mm)


def test_verify_window_capped_at_same_plan_rows(spec_path):
    """k is clamped by ``max_new`` alone, as the JAX engine clamps it: at 16
    and 33 slots (verify windows of 16 x 6 and 33 x 6 rows, beyond
    ``SAME_PLAN_ROWS``) both engines draft 40 and end at clock 25.33, with
    the same tokens; the verify's packed matmuls run in row blocks of at
    most 64 rows instead."""
    for slots in (16, 33):
        runs = []
        for api_mod, kw in ((japi, {}), (tapi, {"device": "cpu"})):
            eng = api_mod.load(spec_path).engine(quality="hi", batch_slots=slots, **ENG,
                                                 **kw)
            rid = eng.submit([1, 2, 3], max_new=12, speculate=api_mod.SpecConfig("lo", k=5))
            eng.run_until_drained()
            st = eng.poll(rid)
            runs.append((st.drafted, eng.now, st.tokens))
        assert runs[1][:2] == runs[0][:2] == (40, pytest.approx(76 / 3, rel=1e-12)), slots
        assert runs[1][2] == runs[0][2] and len(runs[1][2]) == 12


def test_verify_row_blocks_keep_rows(spec_path):
    """``lm_verify`` at 16 slots x W = 6 (M = 96) launches every packed
    matmul as a 64-row and a 32-row block; the logits equal the unblocked
    window's bit for bit on the CPU path, and the dispatch counters still
    count one call per matmul, with the re-read plane words on their own."""
    from repro_torch.kernels import ref as tref
    from repro_torch.models import transformer as ttr

    art = tapi.load(spec_path)
    model = art.model()
    tp, _ = art.serve_params("hi", per_request=True, device="cpu")
    rng = np.random.default_rng(0)
    b, w = 16, 6
    cache = tinit(model.cache_descs(b, 32), device="cpu")
    cache, _ = model.prefill(tp, cache, _t(rng.integers(0, 256, (b, 8), dtype=np.int32)),
                             _t(np.full((b,), 8, np.int32)), _t(np.zeros((b,), np.int32)), 0)
    args = [_t(rng.integers(0, 256, (b, w), dtype=np.int32)), _t(np.full((b,), 8, np.int32)),
            _t(np.full((b,), w, np.int32))]
    tiers = _t(rng.integers(0, 3, (b,), dtype=np.int32))

    def fresh():
        return type(cache)(kv=type(cache.kv)(*(t.clone() for t in cache.kv)))

    tdispatch.reset_counters()
    tref.calls.clear()
    blocked, _ = ttr.lm_verify(tp, model.cfg, fresh(), *args, None, tiers, 0)
    n_calls = tdispatch.counters["gemm"]
    assert n_calls > 0 and tref.calls["qsq_matmul_masked_ref"] + tref.calls[
        "qsq_matmul_ref"] == 2 * n_calls
    assert tdispatch.traffic["row_block_extra_plane_words"] == tdispatch.traffic[
        "plane_words_read"]  # two blocks: each matmul's planes read once more
    whole, _ = ttr._verify(tp, model.cfg, fresh(), *args, tiers, 0)
    assert torch.equal(blocked, whole)


# --------------------------------------------------------------------------
# The engine: speculative streams
# --------------------------------------------------------------------------
def _fuzz_requests(seed):
    """``test_speculative._fuzz_requests``: (prompt, tier, max_new, (draft, k) or None)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(6):
        prompt = rng.integers(1, 255, size=int(rng.integers(2, 7))).tolist()
        max_new = int(rng.integers(2, 8))
        roll = i % 3
        if roll == 0:
            quality, spec = "hi", ("lo", int(rng.integers(1, 6)))
        elif roll == 1:
            quality, spec = "mid", ("lo", int(rng.integers(1, 6)))
        else:
            quality, spec = rng.choice(["hi", "mid"]), None
        reqs.append((prompt, str(quality), max_new, spec))
    return reqs


def _run(eng, api_mod, requests):
    eng.reset_stream()
    rids = [eng.submit(p, max_new=m, quality=q,
                       speculate=None if s is None else api_mod.SpecConfig(*s))
            for p, q, m, s in requests]
    done = eng.run_until_drained()
    return [done[r].tokens for r in rids], [(done[r].drafted, done[r].accepted) for r in rids]


def _plain(art, requests, **kw):
    """Plain solo decode of each request at its own tier."""
    engines = {}
    out = []
    for prompt, quality, max_new, _ in requests:
        if quality not in engines:
            engines[quality] = art.engine(quality=quality, batch_slots=1, **ENG, **kw)
        out.append(engines[quality].generate([prompt], max_new=max_new)[0])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_fuzz_matches_jax_and_plain_decode(spec_path, seed):
    requests = _fuzz_requests(seed)
    tart = tapi.load(spec_path)
    teng = tart.engine(quality="hi", batch_slots=2, device="cpu", **ENG)
    jeng = japi.load(spec_path).engine(quality="hi", batch_slots=2, **ENG)
    ttoks, tcount = _run(teng, tapi, requests)
    jtoks, jcount = _run(jeng, japi, requests)
    assert ttoks == jtoks
    assert tcount == jcount
    assert ttoks == _plain(tart, requests, device="cpu")
    assert teng.stream_stats() == jeng.stream_stats()
    assert teng.stream_stats()["drafted"] > 0


def test_spec_echo_full_window_acceptance(echo_path):
    requests = [([7, 7, 7], "hi", 9, ("echo", 3)), ([5, 2], "hi", 7, ("echo", 2))]
    art = tapi.load(echo_path)
    eng = art.engine(quality="hi", batch_slots=2, device="cpu", **ENG)
    toks, _ = _run(eng, tapi, requests)
    assert toks == _plain(art, requests, device="cpu")
    stats = eng.stream_stats()
    assert stats["drafted"] > 0 and stats["acceptance_rate"] == 1.0


def test_spec_cost_clock_charges_verify_once(spec_path):
    """prefill(hi) + 3 x draft(lo) + ONE verify(hi), equal to JAX's clock."""
    infos = []
    for api_mod, kw in ((tapi, {"device": "cpu"}), (japi, {})):
        eng = api_mod.load(spec_path).engine(quality="hi", batch_slots=1, **ENG, **kw)
        costs = eng.tier_cost_table()
        eng.submit([1, 2, 3], max_new=8, speculate=api_mod.SpecConfig("lo", k=3))
        info = eng.step()
        assert info.drafted == 3
        assert info.cost == pytest.approx(2 * costs[0] + 3 * costs[2], rel=1e-12)
        infos.append((info.cost, info.drafted, info.accepted, eng.now))
        eng.run_until_drained()
    assert infos[0] == infos[1]


def test_spec_submit_validation(spec_path):
    art = tapi.load(spec_path)
    eng = art.engine(quality="hi", batch_slots=1, device="cpu", **ENG)
    bad = [dict(speculate=tapi.SpecConfig("lo", k=0)),
           dict(speculate=tapi.SpecConfig("nope", k=2)),
           dict(quality="lo", speculate=tapi.SpecConfig("lo", k=2)),
           dict(quality="mid", speculate=tapi.SpecConfig("mid", k=2))]
    for kw in bad:
        with pytest.raises(tapi.SubmitRejected):
            eng.submit([1], **kw)
    single = art.engine(quality="hi", per_request=False, batch_slots=1, device="cpu", **ENG)
    with pytest.raises(tapi.SubmitRejected):
        single.submit([1], speculate=tapi.SpecConfig("lo", k=2))


def test_spec_mid_stream_cancel_keeps_survivor_exact(spec_path):
    art = tapi.load(spec_path)
    keep = ([2, 4, 6], "hi", 6, ("lo", 2))
    eng = art.engine(quality="hi", batch_slots=2, device="cpu", **ENG)
    r_keep = eng.submit(keep[0], max_new=keep[2], quality="hi",
                        speculate=tapi.SpecConfig(*keep[3]))
    r_dead = eng.submit([9, 9], max_new=6, quality="hi",
                        speculate=tapi.SpecConfig("mid", k=3))
    eng.step()
    assert eng.cancel(r_dead).finish_reason is not None
    done = eng.run_until_drained()
    assert done[r_keep].tokens == _plain(art, [keep], device="cpu")[0]


def test_phase_traffic_equals_meter(spec_path):
    """Per-call ``phase:draft|verify`` plane words equal the engine's
    analytic meter for those dispatches, and the unlabelled rest too."""
    eng = tapi.load(spec_path).engine(quality="hi", batch_slots=2, device="cpu", **ENG)
    tdispatch.reset_counters()
    try:
        _run(eng, tapi, _fuzz_requests(1))
        words = eng._session.phase_words
        tr = tdispatch.traffic
        for phase in ("draft", "verify"):
            assert tr[f"phase:{phase}:plane_words_read"] == words[phase][0] > 0
            assert tr[f"phase:{phase}:plane_words_full"] == words[phase][1]
        assert tr["plane_words_read"] == sum(r for r, _ in words.values())
        assert 4 * tr["plane_words_read"] == eng.stream_stats()["bytes_read"]
        assert words["draft"][0] < words["draft"][1]  # drafts stream fewer planes
    finally:
        tdispatch.reset_counters()


# --------------------------------------------------------------------------
# serve_speculative on the trained bench model
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench_spec_path(tmp_path_factory):
    from benchmarks import bench_serve

    model, params = bench_serve._spec_model()
    art = japi.compress(model, params, tiers=japi.DEFAULT_TIERS)
    return art.save(tmp_path_factory.mktemp("bench_spec") / "model.edge.npz")


def _sweep(art, api_mod, **kw):
    from benchmarks import bench_serve as bs

    prompts = [[t] * n for t, n in bs.SPEC_PROMPT_SPECS]
    eng_kw = dict(quality="hi", batch_slots=bs.SPEC_SLOTS, max_prompt=8,
                  max_len=8 + bs.SPEC_MAX_NEW + 1, **kw)
    plain = art.engine(**eng_kw)
    rids = [plain.submit(p, max_new=bs.SPEC_MAX_NEW) for p in prompts]
    done = plain.run_until_drained()
    out = {"plain": ([done[r].tokens for r in rids], plain.stream_stats())}
    for draft, k in bs.SPEC_CONFIGS:
        eng = art.engine(**eng_kw)
        rids = [eng.submit(p, max_new=bs.SPEC_MAX_NEW, speculate=api_mod.SpecConfig(draft, k))
                for p in prompts]
        done = eng.run_until_drained()
        out[f"{draft}_k{k}"] = ([done[r].tokens for r in rids], eng.stream_stats())
    return out


def test_serve_speculative_stats_match_jax(bench_spec_path):
    t = _sweep(tapi.load(bench_spec_path), tapi, device="cpu")
    j = _sweep(japi.load(bench_spec_path), japi)
    assert t == j
    plain_toks, plain = t["plain"]
    toks, head = t["lo_k4"]
    assert toks == plain_toks
    assert head["acceptance_rate"] == 1.0
    assert round(head["bytes_per_token"], 1) == 13226.7
    assert round(plain["bytes_per_token"], 1) == 16640.0
    assert round(head["bytes_per_token"] / plain["bytes_per_token"], 4) == 0.7949
