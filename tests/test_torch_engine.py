"""The port's serving engine against the JAX engine on the same artifact.

Both engines load one npz (written by the port, so the JAX package's
compressor is not timed here; ``test_torch_artifact`` covers the other
direction) and serve the same request schedules:

* identical greedy tokens on a mixed-tier stream with staggered arrivals;
* identical ``QualityShed`` decisions (downgrades and sheds) and identical
  deadline and cancellation outcomes;
* equal ``stream_stats()`` bytes/token and ``tier_cost_table()`` — the
  analytic weight-byte meter — and, in the port, the per-call dispatch
  traffic equal to that meter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_scope import port_modules

from repro import api as japi

CFG = dict(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)
ENGINE = dict(quality="mid", batch_slots=3, max_prompt=8, max_len=24)


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, TArch, params_from_numpy, tdispatch, TModel, is_desc, tree_map
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.configs.base import ArchConfig as TArch
        from repro_torch.convert import params_from_numpy
        from repro_torch.kernels import dispatch as tdispatch
        from repro_torch.models.api import Model as TModel
        from repro_torch.models.base import is_desc
        from repro_torch.tree import tree_map
        yield


def numpy_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    descs = TModel(TArch(**CFG, dtype=torch.float32)).param_descs()

    def draw(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return tree_map(draw, descs, is_leaf=is_desc)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    model = TModel(TArch(**CFG, dtype=torch.float32))
    art = tapi.compress(model, params_from_numpy(numpy_params(4), device="cpu"),
                        device="cpu")
    return art.save(tmp_path_factory.mktemp("engine_art") / "model.edge.npz")


@pytest.fixture(scope="module")
def engines(path):
    """(jax engine, port engine), reused across tests via reset_stream()."""
    return japi.load(path).engine(**ENGINE), tapi.load(path).engine(device="cpu", **ENGINE)


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab"], size=int(rng.integers(1, 9))).tolist()
            for _ in range(n)]


def _status(st):
    """Comparable across packages: each owns its FinishReason enum."""
    reason = st.finish_reason.value if st.finish_reason is not None else None
    return (reason, tuple(st.tokens), st.quality, st.requested)


def _stream(eng, prompts, tiers):
    """Staggered arrivals: half up front, the rest mid-stream."""
    eng.reset_stream()
    half = len(prompts) // 2
    rids = [eng.submit(p, max_new=5, quality=q) for p, q in zip(prompts[:half], tiers)]
    eng.step()
    eng.step()
    rids += [eng.submit(p, max_new=4, quality=q)
             for p, q in zip(prompts[half:], tiers[half:])]
    eng.run_until_drained()
    return [_status(eng.poll(r)) for r in rids], eng.stream_stats()


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_tier_staggered_stream_identical(engines, seed):
    jeng, teng = engines
    prompts = _prompts(6, seed)
    tiers = ["hi", "lo", "mid", "lo", "hi", "mid"][seed:] + ["lo"] * seed
    jres, jstats = _stream(jeng, prompts, tiers)
    tres, tstats = _stream(teng, prompts, tiers)
    assert tres == jres
    assert all(r[0] == "done" for r in jres)
    assert tstats == jstats
    assert tstats["bytes_per_token"] > 0


def test_tier_cost_table_equal(engines):
    jeng, teng = engines
    assert teng.tier_cost_table() == jeng.tier_cost_table()
    assert teng.tier_names == jeng.tier_names
    assert teng.n_packed_leaves == jeng.n_packed_leaves == 7


def test_dispatch_traffic_equals_analytic_meter(engines):
    _, teng = engines
    tdispatch.reset_counters()
    try:
        _, stats = _stream(teng, _prompts(4, 3), ["lo", "hi", "mid", "lo"])
        assert 4 * tdispatch.traffic["plane_words_read"] == stats["bytes_read"]
        assert 4 * tdispatch.traffic["plane_words_full"] == stats["bytes_full"]
        assert tdispatch.counters["gemv"] > 0
    finally:
        tdispatch.reset_counters()


def _shed_run(path, make_engine, policy_mod):
    eng = make_engine(path, admission=policy_mod.QualityShed(policy_mod.SLOBudget(
        latency=8.0)))
    rids = [eng.submit(p, max_new=6, quality=q)
            for p, q in zip(_prompts(5, 7), ["hi", "hi", "mid", "hi", "lo"])]
    eng.run_until_drained()
    return [_status(eng.poll(r)) for r in rids]


def test_quality_shed_decisions_identical(path):
    kw2 = {**ENGINE, "batch_slots": 2}
    j = _shed_run(path, lambda p, **kw: japi.load(p).engine(**kw2, **kw), japi)
    t = _shed_run(path, lambda p, **kw: tapi.load(p).engine(device="cpu", **kw2, **kw), tapi)
    assert t == j
    reasons = {r[0] for r in j}
    assert "shed" in reasons, "the schedule must overload the budget"
    assert any(r[2] != r[3] for r in j if r[0] == "done"), \
        "some admission must be downgraded"


def _deadline_cancel_run(eng):
    eng.reset_stream()
    p = _prompts(4, 11)
    r_dead = eng.submit(p[0], max_new=8, quality="hi", deadline=2.5)
    r_live = eng.submit(p[1], max_new=6, quality="lo")
    r_cancel = eng.submit(p[2], max_new=8, quality="mid")
    r_queued = eng.submit(p[3], max_new=3, quality="hi", deadline=1.0)
    eng.step()
    eng.step()
    cancelled = _status(eng.cancel(r_cancel))
    eng.run_until_drained()
    return cancelled, [_status(eng.poll(r)) for r in (r_dead, r_live, r_cancel, r_queued)]


def test_deadline_and_cancel_outcomes_identical(engines):
    jeng, teng = engines
    j = _deadline_cancel_run(jeng)
    t = _deadline_cancel_run(teng)
    assert t == j
    reasons = [r[0] for r in j[1]]
    assert "timed_out" in reasons
    assert "cancelled" in reasons


def test_generate_and_set_quality_identical(engines):
    jeng, teng = engines
    prompts = _prompts(3, 5)
    for eng in engines:
        eng.reset_stream()
        eng.set_quality("lo")
    try:
        assert teng.quality == jeng.quality == "lo"
        assert teng.generate(prompts, max_new=4) == jeng.generate(prompts, max_new=4)
    finally:
        for eng in engines:
            eng.set_quality("mid")


def test_submit_rejections_match(engines):
    for eng in engines:
        eng.reset_stream()
        with pytest.raises(ValueError):
            eng.submit(list(range(9)), max_new=2)  # prompt wider than max_prompt
        with pytest.raises(ValueError):
            eng.submit([1], max_new=20)  # overflows the 24-entry cache
        with pytest.raises(KeyError):
            eng.submit([1], max_new=2, quality="ultra")


def test_port_defers_speculation_and_sampling(engines, path):
    """Speculation and sampling, once deferred, now run: a speculative
    request serves the tokens of the JAX engine, and a sampling engine
    routes ``generate`` to the static path (its submit stays greedy-only)."""
    jeng, teng = engines
    out = []
    for eng, mod in ((teng, tapi), (jeng, japi)):
        eng.reset_stream()
        rid = eng.submit([1, 2], max_new=5, speculate=mod.SpecConfig(draft_tier="lo", k=2))
        out.append(eng.run_until_drained()[rid].tokens)
    assert out[0] == out[1] and len(out[0]) == 5
    eng = tapi.load(path).engine(device="cpu", temperature=0.7, **ENGINE)
    toks = eng.generate([[1, 2]], max_new=2)
    assert len(toks[0]) == 2
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit([1, 2], max_new=2)
