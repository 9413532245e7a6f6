"""The serving steps captured as CUDA graphs, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a
capture needs the card; on the CPU the engine runs the same static-buffer
code without graphs, which ``test_torch_engine.py`` holds against the JAX
engine).  The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

At a 2-layer bf16 config (d 64, G 16: the kernels' tensor-core route) the
same artifact serves a mixed-tier stream with staggered arrivals, a
cancel and speculating requests, once eagerly and once captured:

* the captured tokens equal the eager ones;
* ``no_recapture`` holds across admissions, evictions, a cancel and tier
  flips once every key has been captured;
* the byte meter equals the per-call dispatch traffic after replays, per
  phase too, and the launch counts equal the eager run's;
* there is one graph per demand (decode, admission) and per (demand,
  window width) (verify), and each step syncs the host exactly once.

The MoE family (the qwen3-moe smoke config: 2 layers, d 64, 8 experts
top-2, f32) runs the same stream: captured tokens equal eager ones,
``no_recapture`` holds, and the decode, admission-prefill and verify
logits of a replayed graph equal the eager ones bit for bit (routing,
dispatch and the k-way combine have a fixed order on the card).

The sliding-window ring (the mixtral-8x22b smoke config: window 32, f32)
serves prompts wider than the ring and decodes past it: captured tokens
equal eager ones without re-capture, and the replayed decode and
admission-prefill logits on the wrapped cache equal the eager ones bit for
bit.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

pytestmark = pytest.mark.cuda

CFG = dict(name="graphs-bf16", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
           d_ff=128, vocab=256, remat=False)
ENGINE = dict(quality="mid", batch_slots=4, max_prompt=8, max_len=32)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, dispatch, qsq, no_recapture, StepGraphs
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.analysis import no_recapture
        from repro_torch.kernels import dispatch, qsq
        from repro_torch.serve.graphs import StepGraphs
        yield


@pytest.fixture(scope="module")
def art():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture on the card)")
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    model = Model(ArchConfig(**CFG, dtype=torch.bfloat16))
    params = init_params(model.param_descs(), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    return tapi.compress(model, params, device="cuda")


def _stream(eng, cancel=True):
    """Six requests on four slots: staggered arrivals, lanes re-used at
    other tiers, two speculating from "lo", one cancelled mid-stream."""
    eng.reset_stream()
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, CFG["vocab"], (n,), generator=g).tolist()
               for n in (3, 8, 5, 1, 6, 4)]
    tiers = ["hi", "lo", "mid", "hi", "lo", "mid"]
    spec = tapi.SpecConfig("lo", k=3)
    rids = [eng.submit(p, max_new=7, quality=q, speculate=spec if i == 0 else None)
            for i, (p, q) in enumerate(zip(prompts[:4], tiers))]
    eng.step()
    eng.step()
    if cancel:
        eng.cancel(rids[1])
    rids += [eng.submit(prompts[4], max_new=6, quality=tiers[4]),
             eng.submit(prompts[5], max_new=9, quality=tiers[5], speculate=spec)]
    eng.run_until_drained()
    return [(eng.poll(r).finish_reason.value, eng.poll(r).tokens) for r in rids]


def test_captured_tokens_equal_eager(art):
    eager = _stream(art.engine(device="cuda", eager=True, **ENGINE))
    captured = art.engine(device="cuda", **ENGINE)
    assert captured.eager is False
    assert _stream(captured) == eager
    assert len(captured._session.graphs) > 0


def test_no_recapture_across_admit_evict_and_tier_flip(art):
    eng = art.engine(device="cuda", **ENGINE)
    first = _stream(eng)  # captures every key this schedule needs
    n = len(eng._session.graphs)
    with no_recapture(eng):
        assert _stream(eng) == first
        eng.set_quality("lo")  # the default tier moves: still a data change
        eng.reset_stream()
        rid = eng.submit([5, 6, 7], max_new=4, quality="hi")
        eng.run_until_drained()
        assert eng.poll(rid).finish_reason.value == "done"
    assert len(eng._session.graphs) == n
    with pytest.raises(AssertionError, match="new captures"):
        with no_recapture(eng):
            eng._session.graphs.graphs[("decode", 99)] = None


def test_meter_equals_traffic_after_replays(art):
    eager = art.engine(device="cuda", eager=True, **ENGINE)
    eng = art.engine(device="cuda", **ENGINE)
    _stream(eng)  # the captures count nothing
    counts = []
    for e in (eager, eng):
        dispatch.reset_counters()
        qsq.reset_launches()
        _stream(e)
        stats, words, tr = e.stream_stats(), e._session.phase_words, dispatch.traffic
        assert 4 * tr["plane_words_read"] == stats["bytes_read"]
        assert 4 * tr["plane_words_full"] == stats["bytes_full"]
        for phase in ("draft", "verify"):
            assert [tr[f"phase:{phase}:plane_words_read"],
                    tr[f"phase:{phase}:plane_words_full"]] == words[phase]
        counts.append((dict(dispatch.counters), dict(tr), dict(qsq.launches)))
    assert counts[1] == counts[0]
    assert counts[1][2].get("qsq_matvec_masked", 0) > 0


def test_one_graph_per_demand_and_window(art):
    eng = art.engine(device="cuda", **ENGINE)
    _stream(eng)
    graphs = eng._session.graphs
    keys = graphs.keys()
    assert all(isinstance(rec.graph, torch.cuda.CUDAGraph) for rec in graphs.graphs.values())
    by = {kind: [k[1:] for k in keys if k[0] == kind] for kind in ("decode", "admit", "verify")}
    assert set(by) == {k[0] for k in keys}
    assert len(set(by["decode"])) == len(by["decode"]) <= 3
    assert len(set(by["admit"])) == len(by["admit"]) <= 3
    assert by["verify"] and all(0 <= d <= 2 and 2 <= w <= 4 for d, w in by["verify"])
    assert all(0 <= d[0] <= 2 for d in by["decode"] + by["admit"])


def test_one_host_sync_per_step(art):
    eng = art.engine(device="cuda", **ENGINE)
    _stream(eng, cancel=False)  # capture first: a capture synchronizes
    eng.reset_stream()
    for i, p in enumerate([[1, 2], [3], [4, 5, 6]]):
        eng.submit(p, max_new=6, quality=["hi", "mid", "lo"][i])
    torch.cuda.synchronize()
    per_step = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while eng.has_work:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                info = eng.step()
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            per_step.append((syncs, len(info.admitted) + (1 if info.live else 0)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert per_step and all(s == want for s, want in per_step), per_step


@pytest.fixture(scope="module")
def moe_art():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture on the card)")
    from repro_torch.configs import get_arch
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    model = Model(get_arch("qwen3_moe_30b_a3b", smoke=True))
    params = init_params(model.param_descs(), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    return tapi.compress(model, params, device="cuda")


def test_moe_captured_tokens_equal_eager_without_recapture(moe_art):
    eager = _stream(moe_art.engine(device="cuda", eager=True, **ENGINE))
    eng = moe_art.engine(device="cuda", **ENGINE)
    assert _stream(eng) == eager
    n = len(eng._session.graphs)
    with no_recapture(eng):
        assert _stream(eng) == eager
    assert len(eng._session.graphs) == n > 0


def test_moe_captured_logits_equal_eager(moe_art):
    """Decode, admission prefill and verify of the MoE model, each run
    eagerly on one copy of a primed cache and as a replayed graph on
    another: logits equal bit for bit."""
    eng = moe_art.engine(device="cuda", **ENGINE)
    _stream(eng, cancel=False)
    s, model, params = eng._session, eng.model, eng.params
    b, dev = s.sched.n_slots, eng.device
    g = torch.Generator(device=dev).manual_seed(5)
    tiers = torch.arange(b, device=dev, dtype=torch.int32) % 3
    ones = torch.ones_like(tiers)
    cur = torch.randint(0, CFG["vocab"], (b, 1), generator=g, device=dev, dtype=torch.int32)
    window = torch.randint(0, CFG["vocab"], (b, 3), generator=g, device=dev, dtype=torch.int32)
    toks = torch.randint(0, CFG["vocab"], (1, s.prefill_len), generator=g, device=dev,
                         dtype=torch.int32)
    lens = torch.full((1,), s.prefill_len, dtype=torch.int32, device=dev)
    start = torch.full((b,), 12, dtype=torch.int32, device=dev)
    fns = {
        "decode": lambda c: model.decode(params, c, {
            "tokens": cur, "active": ones, "tiers": tiers, "demand": 0})[0],
        "prefill": lambda c: model.prefill(params, s.zero_slot_cache, toks, lens,
                                           tiers[1:2], 1)[1],
        "verify": lambda c: model.verify(params, c, {
            "tokens": window, "start": start, "wlen": torch.full_like(start, 3),
            "spec": ones, "tiers": tiers, "demand": 0})[0],
    }
    for name, fn in fns.items():
        caches = [type(s.cache)(kv=type(s.cache.kv)(*(t.clone() for t in s.cache.kv)))
                  for _ in range(2)]
        want = fn(caches[0])
        got = StepGraphs(dev).run(name, lambda c=caches[1], f=fn: f(c),
                                  restore=(caches[1].kv.pos,))
        assert torch.equal(want, got), name


def test_ring_captured_equals_eager_without_recapture():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture on the card)")
    from repro_torch.configs import get_arch
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    model = Model(get_arch("mixtral_8x22b", smoke=True))
    params = init_params(model.param_descs(), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    art = tapi.compress(model, params, device="cuda")
    # prompts up to 40 wide into a 32-entry ring, 30 new tokens: every lane wraps
    kw = dict(quality="mid", batch_slots=4, max_prompt=40, max_len=71)
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist() for n in (40, 7, 33, 21, 38)]
    tiers = ["hi", "lo", "mid", "hi", "mid"]

    def stream(eng):
        eng.reset_stream()
        rids = [eng.submit(p, max_new=30, quality=q) for p, q in zip(prompts[:3], tiers)]
        eng.step()
        rids += [eng.submit(p, max_new=30, quality=q) for p, q in zip(prompts[3:], tiers[3:])]
        eng.run_until_drained()
        return [(eng.poll(r).finish_reason.value, eng.poll(r).tokens) for r in rids]

    eager = stream(art.engine(device="cuda", eager=True, **kw))
    assert all(len(t) == 30 for _, t in eager)
    eng = art.engine(device="cuda", **kw)
    assert stream(eng) == eager
    n = len(eng._session.graphs)
    with no_recapture(eng):
        assert stream(eng) == eager
    assert len(eng._session.graphs) == n > 0

    s = eng._session
    assert s.cache.kv.k.shape[2] == 32 and int(s.cache.kv.pos.max()) > 64
    b, dev = s.sched.n_slots, eng.device
    tiers_t = torch.arange(b, device=dev, dtype=torch.int32) % 3
    ones = torch.ones_like(tiers_t)
    cur = torch.randint(0, 256, (b, 1), device=dev, dtype=torch.int32)
    toks = torch.randint(0, 256, (1, s.prefill_len), device=dev, dtype=torch.int32)
    lens = torch.full((1,), s.prefill_len, dtype=torch.int32, device=dev)
    fns = {
        "decode": lambda c: model.decode(eng.params, c, {
            "tokens": cur, "active": ones, "tiers": tiers_t, "demand": 0})[0],
        "prefill": lambda c: model.prefill(eng.params, s.zero_slot_cache, toks, lens,
                                           tiers_t[1:2], 1)[1],
    }
    for name, fn in fns.items():
        caches = [type(s.cache)(kv=type(s.cache.kv)(*(t.clone() for t in s.cache.kv)))
                  for _ in range(2)]
        want = fn(caches[0])
        got = StepGraphs(dev).run(name, lambda c=caches[1], f=fn: f(c),
                                  restore=(caches[1].kv.pos,))
        assert torch.equal(want, got), name
