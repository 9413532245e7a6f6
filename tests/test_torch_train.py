"""Training with QSQ gradient compression: the port against the JAX package.

Both packages start from the same state (the JAX ``TrainState`` carried
across with ``convert.train_state_from_numpy``) and see the same batches,
made with numpy from a seed, at the ``bench_serve._model`` config (2
layers, d64, 4/2 heads, ff128, vocab 256, f32).  Tolerances, with why:

* logits within atol = rtol = 1e-4 and the loss within rtol 1e-5: two f32
  matmul orders; gradients within rtol 1e-4 of each leaf's largest;
* AdamW and the cosine schedule within rtol 1e-5 (f32 pow/sqrt/cos of two
  libraries);
* one train step with compression: loss, grad norm and LR scale as above,
  ``grad_wire_bytes`` exact; the new state's leaves within the same
  tolerances except at most 0.1% of values (a nearest-level near-tie in
  the encoder can flip one code under last-bit gradient differences);
* a 5-step ``Trainer`` run: losses within rtol 1e-4.  Error feedback
  carries each such flip into later steps, so states drift apart by a few
  learning rates at single values while the loss stays put.

The port's own fault tolerance (checkpoint resume bit for bit, preemption,
the straggler watchdog) repeats ``tests/test_trainer.py`` on the CPU, and
checkpoints cross between the packages in both directions.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch_port_scope import port_modules

from repro.checkpoint import CheckpointConfig as JCkptConfig
from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs.base import ArchConfig as JArch
from repro.data.pipeline import _bigram_table as jbigram
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamW
from repro.optim import GradCompressionConfig as JGC
from repro.optim import OptState as JOptState
from repro.optim import adamw_update as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.train.state import TrainState as JTrainState
from repro.train.state import train_state_descs as jstate_descs
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig

CFG = dict(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=128, vocab=256, remat=False)
B, S, STEPS, LR = 4, 16, 5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port for this file only (see ``torch_port_scope``)."""
    global T
    with port_modules():
        import repro_torch.checkpoint as ckpt
        import repro_torch.configs as configs
        import repro_torch.convert as convert
        import repro_torch.core.policy as policy
        import repro_torch.data.pipeline as data
        import repro_torch.launch.train as launch
        import repro_torch.models.api as api
        import repro_torch.models.base as base
        import repro_torch.models.layers as layers
        import repro_torch.optim as optim
        import repro_torch.train.step as step
        import repro_torch.train.trainer as trainer
        import repro_torch.tree as tree

        T = dict(ckpt=ckpt, configs=configs, convert=convert, policy=policy, data=data,
                 launch=launch, api=api, base=base, layers=layers, optim=optim, step=step,
                 trainer=trainer, tree=tree)
        yield


def _tmodel(**kw):
    return T["api"].Model(T["configs"].ArchConfig(**{**CFG, **kw}, dtype=torch.float32))


def _jmodel():
    return JModel(JArch(**CFG, dtype=jnp.float32))


@pytest.fixture(scope="module")
def jstate():
    """The JAX TrainState (compression on) as numpy leaves."""
    jm = _jmodel()
    s = jinit(jax.random.PRNGKey(0), jstate_descs(jm, JGC(enabled=True)))
    return jax.tree_util.tree_map(np.asarray, s)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (B, S)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        labels[0, -3:] = -1  # masked positions
        out.append({"tokens": toks, "labels": labels})
    return out


@pytest.fixture(scope="module")
def trainers(jstate, batches):
    """A JAX and a port Trainer, 5 steps each from the same state."""
    tc = dict(total_steps=STEPS, log_every=1)
    jtr = JTrainer(_jmodel(), JTrainerConfig(**tc, opt=JAdamW(lr=LR),
                                             compression=JGC(enabled=True)),
                   lambda s: {k: jnp.asarray(v) for k, v in batches[s].items()})
    ttr = T["trainer"].Trainer(
        _tmodel(), T["trainer"].TrainerConfig(**tc, opt=T["optim"].AdamWConfig(lr=LR),
                                              compression=T["optim"].GradCompressionConfig(
                                                  enabled=True)),
        lambda s: batches[s], device="cpu")
    return jtr, ttr


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jstate(np_state):
    """Fresh JAX arrays (the JAX Trainer donates its state)."""
    return JTrainState(params=_jnp_tree(np_state.params),
                       opt=JOptState(*(_jnp_tree(x) for x in np_state.opt)),
                       err=_jnp_tree(np_state.err))


def _pairs(jtree, ttree):
    """[(keystr, jax leaf, port leaf)] over two trees of one structure."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = T["tree"].tree_leaves_with_path(ttree)
    assert len(jflat) == len(tflat)
    out = []
    for (jp, jl), (tp, tl) in zip(jflat, tflat, strict=True):
        assert jax.tree_util.keystr(jp) == T["tree"].keystr(tp)
        tl = tl.detach().numpy() if isinstance(tl, torch.Tensor) else np.asarray(tl)
        out.append((jax.tree_util.keystr(jp), np.asarray(jl), tl))
    return out


def _close(j, t, rtol, frac=0.0):
    """Leafwise |t - j| <= rtol * max|j| (+ tiny), allowing ``frac`` of values off."""
    tol = rtol * max(float(np.max(np.abs(j))), 1e-30) + 1e-12
    off = np.abs(t.astype(np.float64) - j) > tol
    assert off.mean() <= frac, f"{int(off.sum())} of {off.size} values off by > {tol:.2e}"


# --------------------------------------------------------------------------
# The forward, the loss and its gradients
# --------------------------------------------------------------------------
def test_lm_loss_logits_and_grads_match_jax(jstate, batches):
    jm, tm = _jmodel(), _tmodel()
    b = batches[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(_jnp_tree(jstate.params), jb)
    jlogits = jax.jit(jm.forward)(_jnp_tree(jstate.params), jb)
    params = T["tree"].tree_map(lambda p: p.requires_grad_(True),
                                T["convert"].params_from_numpy(jstate.params, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = tm.loss(params, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(tm.forward(params, tb).numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
    for _, j, t in _pairs(jgrads, T["tree"].tree_map(lambda p: p.grad, params)):
        _close(j, t, 1e-4)
    # labels < 0 drop out of the mean; an all-masked batch is 0, not nan
    with torch.no_grad():
        tl = tm.loss(params, {**tb, "labels": torch.full_like(tb["labels"], -1)})
    assert float(tl) == 0.0


def test_q_chunked_attention_matches_jax():
    rng = np.random.default_rng(4)
    p = {"wq": rng.standard_normal((64, 4, 16)), "wk": rng.standard_normal((64, 2, 16)),
         "wv": rng.standard_normal((64, 2, 16)), "wo": rng.standard_normal((4, 16, 64))}
    p = {k: (v * 0.1).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    want = np.asarray(jlayers.attention(_jnp_tree(p), jnp.asarray(x), positions=jnp.asarray(pos),
                                        q_chunk=8))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for chunk in (8, 2048):
        got = T["layers"].attention(tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                    q_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # a sliding window of 4: the (window + chunk) kv slices at q_chunk 8, one
    # windowed mask at 2048
    want = np.asarray(jlayers.attention(_jnp_tree(p), jnp.asarray(x), positions=jnp.asarray(pos),
                                        window=4, q_chunk=8))
    for chunk in (8, 2048):
        got = T["layers"].attention(tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                    window=4, q_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# Optimizer and schedule
# --------------------------------------------------------------------------
def test_adamw_update_matches_jax():
    rng = np.random.default_rng(5)
    shapes = {"a": (16, 8), "b": (8,), "c": (2, 3, 4)}

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}

    params, grads, m = tree(1.0), tree(2.0), tree(0.1)
    v = {k: np.abs(x) for k, x in tree(0.1).items()}
    step = np.int32(3)
    for lr_scale in (1.0, 0.37):
        jp, jo, jn = jax.jit(jadamw, static_argnums=0)(
            JAdamW(), _jnp_tree(params), _jnp_tree(grads),
            JOptState(m=_jnp_tree(m), v=_jnp_tree(v), step=jnp.asarray(step)),
            jnp.float32(lr_scale))
        cv = T["convert"].params_from_numpy
        tp, to, tn = T["optim"].adamw_update(
            T["optim"].AdamWConfig(), cv(params, "cpu"), cv(grads, "cpu"),
            T["optim"].OptState(m=cv(m, "cpu"), v=cv(v, "cpu"), step=torch.tensor(step)),
            torch.tensor(lr_scale, dtype=torch.float32))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)  # clipped: |g| > 1
        assert int(to.step) == int(jo.step) == 4 and to.step.dtype == torch.int32
        for _, j, t in _pairs((jp, jo.m, jo.v), (tp, to.m, to.v)):
            _close(j, t, 1e-5)
    # decay only on >= 2-D leaves: with zero grads a 1-D leaf stays put
    zeros = {k: np.zeros_like(x) for k, x in params.items()}
    tp, _, _ = T["optim"].adamw_update(
        T["optim"].AdamWConfig(), cv(params, "cpu"), cv(zeros, "cpu"),
        T["optim"].OptState(m=cv(zeros, "cpu"), v=cv(zeros, "cpu"), step=torch.tensor(0)))
    assert torch.equal(tp["b"], torch.from_numpy(params["b"]))
    assert not torch.equal(tp["a"], torch.from_numpy(params["a"]))


def test_cosine_schedule_matches_jax():
    steps = np.arange(0, 130, dtype=np.int32)
    for warmup, total in ((5, 100), (1, 5), (100, 100)):
        want = np.asarray(jcosine(jnp.asarray(steps), warmup=warmup, total=total))
        got = T["optim"].cosine_schedule(torch.from_numpy(steps), warmup=warmup, total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# One train step and a 5-step Trainer run
# --------------------------------------------------------------------------
def test_train_step_matches_jax(jstate, batches, trainers):
    jtr, ttr = trainers
    start = jstate._replace(opt=jstate.opt._replace(step=np.int32(2)))  # past warm-up
    js, jm = jtr.step_fn(_jstate(start), {k: jnp.asarray(v) for k, v in batches[1].items()})
    ts, tm = ttr.step_fn(T["convert"].train_state_from_numpy(start, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batches[1].items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr_scale"]), float(jm["lr_scale"]), rtol=1e-6)
    assert float(jm["lr_scale"]) > 0.5
    assert tm["grad_wire_bytes"] == float(jm["grad_wire_bytes"]) == 189440.0
    assert int(ts.opt.step) == 3
    for key, j, t in _pairs(js, ts):
        if j.ndim:
            _close(j, t, 1e-4, frac=1e-3)
        else:
            assert t == j, key


def test_trainer_five_steps_matches_jax(jstate, trainers):
    jtr, ttr = trainers
    _, jlast = jtr.run(state=_jstate(jstate), start_step=0)
    _, tlast = ttr.run(state=T["convert"].train_state_from_numpy(jstate, "cpu"), start_step=0)
    assert jlast == tlast == STEPS
    jl = [m["loss"] for m in jtr.metrics_log]
    tl = [m["loss"] for m in ttr.metrics_log]
    assert [m["step"] for m in ttr.metrics_log] == list(range(STEPS))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# --------------------------------------------------------------------------
# Fault tolerance (the port's versions of tests/test_trainer.py:53-103)
# --------------------------------------------------------------------------
def _mk_trainer(tmp_path, steps=8, every=4, name="ck"):
    cfg = T["configs"].get_arch("smollm_135m", smoke=True)
    data = T["data"].LMDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    tc = T["trainer"].TrainerConfig(
        total_steps=steps, log_every=1, opt=T["optim"].AdamWConfig(lr=1e-3),
        compression=T["optim"].GradCompressionConfig(enabled=True, min_numel=64),
        checkpoint=T["ckpt"].CheckpointConfig(directory=str(tmp_path / name),
                                              every_steps=every, async_save=False))
    return T["trainer"].Trainer(T["api"].Model(cfg), tc, lambda s: T["data"].lm_batch(data, s),
                                device="cpu")


def _tree_equal(a, b):
    fa, fb = T["tree"].tree_leaves(a), T["tree"].tree_leaves(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb, strict=True))


def test_checkpoint_resume_bit_exact(tmp_path):
    """8 straight steps vs 4 + preemption + resume 4: the same final state,
    error-feedback buffers included."""
    s_full, _ = _mk_trainer(tmp_path, every=100, name="full").run()
    t_a = _mk_trainer(tmp_path, name="resume")
    t_a.run(step_hook=lambda step, *_: step == 3 and t_a.request_preemption())
    state_b, last = _mk_trainer(tmp_path, name="resume").run()
    assert last == 8
    assert _tree_equal(s_full, state_b)


def test_preemption_checkpoints_and_resumes(tmp_path):
    tr = _mk_trainer(tmp_path, steps=100, every=1000, name="pre")
    calls = []

    def hook(step, state, metrics):
        calls.append(step)
        if step == 3:
            tr.request_preemption()

    _, last = tr.run(step_hook=hook)
    assert last == 4 and calls == [0, 1, 2, 3]
    mgr = T["ckpt"].CheckpointManager(tr.cfg.checkpoint)
    assert mgr.latest_step() == 4
    meta = mgr.restore(tr.init_state()[0])[1]
    assert meta["preempted"] is True and meta["data_state"] == {"step": 4}
    _, start = _mk_trainer(tmp_path, steps=6, every=1000, name="pre").init_state()
    assert start == 4


def test_straggler_watchdog(tmp_path):
    """Step 15 stalls for 1 s, or for 4x the slowest step before it where
    that is longer (a loaded host can make a step take over 1/3 s), so it
    is a straggler against the running median whatever the host's speed."""
    tr = _mk_trainer(tmp_path, steps=20, every=1000, name="strag")

    def hook(step, *_):
        if step == 15:
            time.sleep(max(1.0, 4 * max(m["sec_per_step"] for m in tr.metrics_log)))

    tr.run(step_hook=hook)
    assert any(e["step"] == 15 for e in tr.straggler_events)


# --------------------------------------------------------------------------
# Checkpoints across packages
# --------------------------------------------------------------------------
def test_checkpoint_keys_are_jax_keystr(tmp_path, jstate):
    ts = T["convert"].train_state_from_numpy(jstate, "cpu")
    path = T["ckpt"].save_pytree(ts, tmp_path / "s.npz")
    want = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    with np.load(path) as data:
        assert set(data.files) == want
    assert ".params['blocks']['attn']['wq']" in want and ".opt.step" in want


def test_port_checkpoint_restored_by_jax(tmp_path, jstate):
    rng = np.random.default_rng(6)
    moved = jax.tree_util.tree_map(
        lambda a: a + rng.standard_normal(a.shape).astype(a.dtype) if a.dtype == np.float32
        else a + 7, jstate)
    mgr = T["ckpt"].CheckpointManager(T["ckpt"].CheckpointConfig(directory=str(tmp_path)))
    mgr.save(T["convert"].train_state_from_numpy(moved, "cpu"), 3, extra={"data_state": 3})
    mgr.wait()
    restored, meta = JCkpt(JCkptConfig(directory=str(tmp_path))).restore(jstate)
    assert meta == {"step": 3, "data_state": 3}
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                              jax.tree_util.tree_flatten_with_path(moved)[0], strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_checkpoint_restored_by_port(tmp_path, jstate):
    JCkpt(JCkptConfig(directory=str(tmp_path), async_save=False)).save(
        _jstate(jstate), 5, extra={"data_state": {"step": 5}})
    like = T["convert"].train_state_from_numpy(jstate, "cpu")
    restored, meta = T["ckpt"].CheckpointManager(
        T["ckpt"].CheckpointConfig(directory=str(tmp_path))).restore(like)
    assert meta["step"] == 5 and type(restored) is type(like)
    assert restored.opt.step.dtype == torch.int32
    for _, j, t in _pairs(jstate, restored):
        np.testing.assert_array_equal(t, j)


def test_checkpoint_bfloat16_and_wire_export(tmp_path):
    """bf16 leaves round-trip bit for bit in JAX's raw-word form, and the
    QSQ wire export loads identically in both packages."""
    mgr = T["ckpt"].CheckpointManager(T["ckpt"].CheckpointConfig(directory=str(tmp_path)))
    x = torch.randn((4, 6), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    path = T["ckpt"].save_pytree({"w": x}, tmp_path / "bf.npz")
    assert torch.equal(T["ckpt"].load_pytree({"w": x}, path)["w"], x)
    with np.load(path) as data:
        j = jnp.asarray(data["['w']"].view(jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(j, np.float32), x.float().numpy())
    tm = _tmodel()
    params = T["convert"].params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(1), _jmodel().param_descs())),
        "cpu")
    mgr.export_wire(params, T["policy"].QuantPolicy(), descs=tm.param_descs())
    twire = mgr.load_wire()
    jwire = JCkpt(JCkptConfig(directory=str(tmp_path))).load_wire()
    assert len(T["tree"].tree_leaves(twire)) == len(jax.tree_util.tree_leaves(jwire)) > 12
    for a, b in zip(T["tree"].tree_leaves(twire), jax.tree_util.tree_leaves(jwire), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------
# Data stream, conversion, step builders, launcher
# --------------------------------------------------------------------------
def test_lm_batch_stream():
    cfg = T["data"].LMDataConfig(vocab=256, seq_len=12, global_batch=3, seed=2)
    table = T["data"]._bigram_table(256, 8, 2)
    np.testing.assert_array_equal(table, jbigram(256, 8, 2))
    b = T["data"].lm_batch(cfg, 5)
    toks, labels = b["tokens"].numpy(), b["labels"].numpy()
    assert toks.dtype == np.int32 and toks.shape == (3, 12)
    for row in toks:  # every move follows the bigram graph
        assert all(nxt in table[cur] for cur, nxt in zip(row[:-1], row[1:], strict=True))
    np.testing.assert_array_equal(labels, np.roll(toks, -1, axis=1))
    assert torch.equal(T["data"].lm_batch(cfg, 5)["tokens"], b["tokens"])
    assert not torch.equal(T["data"].lm_batch(cfg, 6)["tokens"], b["tokens"])
    it = T["data"].lm_batch_iterator(cfg, T["data"].DataIteratorState(step=5, seed=2))
    st, b5 = next(it)
    assert st.step == 6 and torch.equal(b5["tokens"], b["tokens"])


def test_train_state_convert_roundtrip_and_unported_families(jstate):
    ts = T["convert"].train_state_from_numpy(jstate, "cpu")
    back = T["convert"].train_state_to_numpy(ts)
    for (_, a), b in zip(jax.tree_util.tree_flatten_with_path(jstate)[0],
                         T["tree"].tree_leaves(back), strict=True):
        np.testing.assert_array_equal(b, a)
    assert ts.err["blocks"]["ln1"].shape == () and ts.err["embed"]["tok"].shape == (256, 64)
    # the encoder-decoder and vision families' parameter trees (cross
    # blocks, encoder blocks, the (1,) gates) cross and come back bit for bit
    for family, extra in (("encdec", {"enc_layers": 2}), ("vlm", {"cross_every": 1})):
        model = T["api"].Model(T["configs"].ArchConfig(**{**CFG, "family": family}, **extra,
                                                       dtype=torch.float32))
        tree = T["base"].init_params(model.param_descs(), torch.Generator().manual_seed(1),
                                     device="cpu")
        arrays = T["convert"].params_to_numpy(tree)
        back = T["convert"].params_from_numpy(arrays, "cpu")
        pairs = list(zip(T["tree"].tree_leaves(tree), T["tree"].tree_leaves(back), strict=True))
        assert all(torch.equal(a, b) for a, b in pairs)
        assert ("enc_blocks" if family == "encdec" else "cross_blocks") in back
    assert back["cross_blocks"]["gate"].shape == (2, 1)


def test_prefill_and_serve_steps(jstate, batches):
    tm = _tmodel()
    params = T["convert"].params_from_numpy(jstate.params, "cpu")
    toks = torch.from_numpy(batches[0]["tokens"])
    with torch.no_grad():
        logits = T["step"].make_prefill_step(tm)(params, {"tokens": toks})
    assert tuple(logits.shape) == (B, S, 256)
    cache = T["base"].init_params(tm.cache_descs(B, 8), device="cpu")
    nxt, cache = T["step"].make_serve_step(tm)(params, cache, {"tokens": toks[:, :1]})
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (B, 1)
    np.testing.assert_array_equal(nxt[:, 0].numpy(), logits[:, 0].argmax(-1).numpy())


def test_launcher_trains_and_checkpoints_on_cpu(tmp_path):
    tr = T["launch"].main(["--steps", "3", "--batch", "2", "--seq", "16", "--grad-compression",
                           "--device", "cpu", "--ckpt", str(tmp_path / "run")])
    assert tr.device.type == "cpu" and len(tr.metrics_log) == 3
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert T["ckpt"].CheckpointManager(tr.cfg.checkpoint).latest_step() == 3
