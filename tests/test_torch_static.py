"""The static two-program path and the fault injectors against the JAX package.

* ``ServeConfig(continuous=False)``: one prefill of every slot, then one
  decode loop; greedy tokens equal the JAX engine's ``_generate_static``
  on one artifact loaded by both packages, and equal the port's own
  continuous path.
* ``temperature > 0`` samples from a ``torch.Generator`` seeded from
  ``seed``: the same seed and prompts give the same tokens (the draws
  differ from ``jax.random``'s, so there is no token parity with JAX);
  at a vanishing temperature the sampler is the greedy path.
* ``repro_torch.serve.faults``: the wire-damage injectors write the same
  npz as the JAX package's, the traces are equal, and ``replay`` of one
  overload trace gives the same scorecard on both engines.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro import api as japi
from repro.configs.base import ArchConfig as JArch
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.serve import faults as jfaults

CFG = dict(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)
PROMPTS = [[5, 9, 2], [17], [3, 3, 3, 3, 8, 1], [250, 1]]


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global tapi, tfaults
    with port_modules():
        from repro_torch import api as tapi
        from repro_torch.serve import faults as tfaults
        yield


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    model = JModel(JArch(**CFG, dtype=jnp.float32))
    params = jinit(jax.random.PRNGKey(1), model.param_descs())
    return japi.compress(model, params).save(tmp_path_factory.mktemp("static") / "m.npz")


def _engine(api_mod, path, **kw):
    extra = {"device": "cpu"} if api_mod is tapi else {}
    return api_mod.load(path).engine(**{"batch_slots": 4, **kw}, **extra)


@pytest.mark.parametrize("quality", ["hi", "lo"])
def test_static_greedy_matches_jax(path, quality):
    kw = dict(quality=quality, continuous=False)
    t = _engine(tapi, path, **kw)
    assert not t.per_request_quality  # the static path serves one tier
    want = _engine(japi, path, **kw).generate(PROMPTS, max_new=6)
    assert t.generate(PROMPTS, max_new=6) == want
    assert all(len(x) == 6 for x in want)


def test_static_equals_continuous_greedy(path):
    cont = _engine(tapi, path, quality="mid", per_request=False)
    static = _engine(tapi, path, quality="mid", continuous=False)
    assert static.generate(PROMPTS[:3], max_new=5) == cont.generate(PROMPTS[:3], max_new=5)


def test_single_tier_engine_static_matches_jax(path):
    kw = dict(quality="mid", per_request=False, continuous=False, batch_slots=2)
    assert (_engine(tapi, path, **kw).generate(PROMPTS[:2], max_new=4)
            == _engine(japi, path, **kw).generate(PROMPTS[:2], max_new=4))


def test_sampling_reproducible_from_seed(path):
    eng = _engine(tapi, path, quality="hi", temperature=0.8)
    a = eng.generate(PROMPTS, max_new=8, seed=3)
    assert a == eng.generate(PROMPTS, max_new=8, seed=3)
    assert a != eng.generate(PROMPTS, max_new=8, seed=4)
    assert all(len(x) == 8 and all(0 <= t < CFG["vocab"] for t in x) for x in a)


def test_sampling_at_vanishing_temperature_is_greedy(path):
    greedy = _engine(tapi, path, quality="hi", continuous=False).generate(PROMPTS, max_new=6)
    cold = _engine(tapi, path, quality="hi", temperature=1e-6).generate(PROMPTS, max_new=6,
                                                                        seed=0)
    assert cold == greedy


def test_static_routing_errors_match_jax(path):
    for api_mod in (tapi, japi):
        hot = _engine(api_mod, path, quality="hi", temperature=0.7)
        with pytest.raises(ValueError, match="greedy-only"):
            hot.submit([1, 2], max_new=3)
        with pytest.raises(ValueError, match="continuous scheduler"):
            _engine(api_mod, path, continuous=False).generate(PROMPTS[:2], max_new=2,
                                                               qualities="lo")
        assert hot.generate([], max_new=3) == []
        assert hot.generate(PROMPTS[:2], max_new=0) == [[], []]


# --------------------------------------------------------------------------
# Fault injectors
# --------------------------------------------------------------------------
def _npz(p):
    with np.load(p) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("inject", ["corrupt_lsb", "corrupt_msb", "truncate_all",
                                    "truncate_named"])
def test_wire_damage_injectors_match_jax(path, tmp_path, inject):
    names = sorted(dict(japi.load(path).drop_map("lo")))
    calls = {
        "corrupt_lsb": ("corrupt_plane_npz", dict(plane=2, leaf="wq", n_flips=6, seed=2)),
        "corrupt_msb": ("corrupt_plane_npz", dict(plane=0, seed=1)),
        "truncate_all": ("truncate_planes_npz", dict(drop=1)),
        "truncate_named": ("truncate_planes_npz", dict(drop=2, leaves=names[:2])),
    }
    fn, kw = calls[inject]
    jout = getattr(jfaults, fn)(path, out=tmp_path / "j.npz", **kw)
    tout = getattr(tfaults, fn)(path, out=tmp_path / "t.npz", **kw)
    j, t = _npz(jout), _npz(tout)
    assert sorted(j) == sorted(t)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert any(not np.array_equal(j[k], v) for k, v in _npz(path).items()), "no damage"


def test_traces_and_injectors_match_jax():
    arr = jfaults.poisson_trace(7, 1.5, seed=4)
    assert tfaults.poisson_trace(7, 1.5, seed=4) == arr
    assert tfaults.overload_trace(arr, 3.0) == jfaults.overload_trace(arr, 3.0)
    assert tfaults.burst_trace(3, at=2.0) == jfaults.burst_trace(3, at=2.0)
    t, j = tfaults.slow_ticks(3, 0.5), jfaults.slow_ticks(3, 0.5)
    assert [t(i) for i in range(7)] == [j(i) for i in range(7)]
    with pytest.raises(ValueError):
        tfaults.slow_ticks(0, 1.0)


def test_replay_scorecard_matches_jax(path):
    """4x overload with QualityShed admission and slow ticks: the same
    scorecard (latencies on the cost clock, rates, quality mix, depth)."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, CFG["vocab"], size=int(rng.integers(1, 7))).tolist()
               for _ in range(8)]
    arrivals = jfaults.overload_trace(jfaults.poisson_trace(8, 2.0, seed=1), 4.0)
    out = []
    for api_mod, faults in ((tapi, tfaults), (japi, jfaults)):
        eng = _engine(api_mod, path, quality="hi", batch_slots=2, max_prompt=8, max_len=24,
                      admission=api_mod.QualityShed(api_mod.SLOBudget(latency=10.0)))
        with pytest.raises(api_mod.SubmitRejected):
            eng.submit(faults.oversized_prompt(eng), max_new=2)
        eng.reset_stream()
        rep = faults.replay(eng, prompts, arrivals, max_new=4, qualities="hi",
                            slow=faults.slow_ticks(3, 0.5))
        out.append((rep.summary(), {r: tuple(s.tokens) for r, s in rep.statuses.items()}))
    assert out[0] == out[1]
    assert out[0][0]["n"] == 8 and out[0][0]["done_rate"] > 0
