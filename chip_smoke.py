#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(nvcc, sm_90a) and drives the port end to end:

1. card identity (``nvidia-smi`` name and power limit) and the build;
2. each kernel against its plain PyTorch version at smollm-135m's packed
   shapes — elementwise within 2*K*2^-24*(|x|@|w|), masked rows
   bit-identical to the unmasked kernel on truncated planes, demand-routed
   bit-identical to full masked — and timed with CUDA events, the masked
   kernels also at demand_drop = 2 against that case's own bound;
3. the main path at full width: ``api.compress`` of smollm-135m (random
   weights from a seeded ``torch.Generator``), ``save``,
   ``api.load(verify=True)``, ``artifact.engine(quality="mid",
   batch_slots=8)`` serving 12 mixed-tier requests with staggered
   arrivals; every kernel must launch and no plain version may run; then
   profiles of 4 decode steps and of one admission (device time by
   kernel, each packed kernel's share and launches);
4. the card against the CPU at the 2-layer d64 test config: identical
   greedy tokens, logits within 1e-4;
5. the encoder K5 (``qsq_quantize``) against its plain version at the
   eleven gradient shapes of smollm-135m, a ragged N, every G in {2, 16,
   32, 64}, phi in {1, 2, 4}, f32 and bf16: codes and scales bit for bit;
   ``pack_weight`` -> ``qsq_matmul`` within the f32 bound; K5 timed cold;
6. the second main path at full width: the ``Trainer`` trains smollm-135m
   (random weights from seed 0) with QSQ gradient compression, batch 8 x
   seq 128, checkpointing every 3 steps; K5 must launch 11 times a step
   and the plain encoder never; ``grad_wire_bytes`` is 277,004,448; a run
   resumed from the step-3 checkpoint ends bit for bit where the
   continuous one did (deterministic algorithms on); one step profiled;
7. the card against the CPU at the d64 test config: 3 train steps from one
   state, losses within rtol 1e-4, the step-0 gradients within 2e-4 of
   each leaf's largest, compressed ones too except at near-ties;
8. the third main path at full width, on phase 3's artifact: speculative
   and static serving.  Verify rows (K4 at M = 40, K3 for the untiered
   leaves) equal decode rows (K2/K1 at M = 8) bit for bit at the five
   shapes, and the new shapes (M = 40, the static prefill M) pass phase
   2's checks and are timed; 12 mixed hi/mid requests on 8 slots, half
   speculating with SpecConfig("lo", 4), give the tokens of the same
   requests served plainly, with K2 in every draft tick, K4 in every
   verify, no plain version, and phase-labelled plane words equal to the
   engine's meter; one speculative round profiled; the echo ladder
   (a draft tier that drops nothing) accepts every draft; greedy
   ``generate(continuous=False)`` on a single-tier engine launches K1 and
   K3, and where it leaves the continuous path's tokens (at 30 layers and
   at 2) the continuous top-2 logit gap is at most twice that path's bf16
   error against f32 arithmetic there (a tie); two sampled runs
   (temperature 0.8) from one seed agree; and at the d64 f32 config the
   card's speculative and static tokens equal the CPU's, verify logits
   within 1e-4.

Any failed check raises, so the script exits non-zero and prints no
result.  The second-to-last line is the per-kernel JSON summary and the
last line ``{"ok": true, "device": {...}}``.  The compiler's register and
shared-memory report goes to ``build/kernels/build.log``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 non-tensor
SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576), (576, 49152)]  # (K, N)
GROUP = 16
M_GEMV, M_GEMM = 8, 64
KERNELS = {
    # name: (masked, M, source, the TPU kernel's pallas_call)
    "qsq_matvec": (False, M_GEMV, "src/repro_torch/kernels/csrc/qsq_matvec.cu",
                   "src/repro/kernels/qsq_matvec.py:224"),
    "qsq_matvec_masked": (True, M_GEMV, "src/repro_torch/kernels/csrc/qsq_matvec.cu",
                          "src/repro/kernels/qsq_matvec.py:163"),
    "qsq_matmul": (False, M_GEMM, "src/repro_torch/kernels/csrc/qsq_matmul.cu",
                   "src/repro/kernels/qsq_matmul.py:298"),
    "qsq_matmul_masked": (True, M_GEMM, "src/repro_torch/kernels/csrc/qsq_matmul.cu",
                          "src/repro/kernels/qsq_matmul.py:242"),
}


K5 = ("qsq_quantize", "src/repro_torch/kernels/csrc/qsq_quantize.cu",
      "src/repro/kernels/qsq_quantize.py:73")
# (K, N, G) of the 11 gradient leaves K5 encodes per smollm-135m train step:
# embed.tok, embed.head, then the 30-layer stacks flattened to (30, rest)
# and grouped along the layer axis (G = 2), as optim/compression.py does
K5_SHAPES = [(49152, 576, 64), (576, 49152, 64), (30, 576, 2), (30, 576, 2),
             (30, 331776, 2), (30, 331776, 2), (30, 110592, 2), (30, 110592, 2),
             (30, 884736, 2), (30, 884736, 2), (30, 884736, 2)]
WIRE_BYTES = 277_004_448  # (3 bits x 162,825,984 values + 32 x 6,750,720 scales) / 8


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
class Flush:
    """Writes 64 MB between timed launches so every launch finds the 50 MB
    L2 cold, as the decode step's 78 MB weight stream does."""

    def __init__(self, torch):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.zero_()


SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's 1.98 GHz boost clock


def time_ms(torch, fn, flush, runs=25, warmup=3) -> float:
    """Median of ``runs`` cold single-call CUDA-event timings, in ms.

    A ~2 ms spin on the stream before the first event lets the host queue
    the call's launches while the card waits, so the time is the device's
    and not the host's dispatch latency (~60 us a launch on the test
    machine; a plain version's many launches may still outrun the spin)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def operands(torch, m, k, n, gen, x_dtype, min_drop=0):
    from repro_torch.kernels.ref import MASK_VARIANTS

    x = torch.randn((m, k), generator=gen, device="cuda").to(x_dtype)
    planes = torch.randint(-2**31, 2**31 - 1, (3, k // 32, n), generator=gen,
                           device="cuda", dtype=torch.int32)
    scales = torch.rand((k // GROUP, n), generator=gen, device="cuda") * 0.09 + 0.01
    variants = torch.tensor(MASK_VARIANTS[min_drop:], dtype=torch.int32, device="cuda")
    pick = torch.randint(0, len(variants), (m,), generator=gen, device="cuda")
    return x, planes, scales, variants[pick].contiguous()


def f32_bound(torch, x, plane_mask, planes, scales, demand):
    """2*K*2^-24*(|x| @ |w|) per output, each row with its own mask's weight."""
    from repro_torch.kernels import ref

    k = x.shape[1]
    xs = ref.variant_split(x.float().abs(), plane_mask, demand)
    out = 0
    for i, mask in enumerate(ref.MASK_VARIANTS[demand:]):
        w = ref.qsq_dequant_ref(planes, scales, GROUP, sign_mag=True, plane_major=True,
                                n_planes=3 - demand, code_mask=mask).to(x.dtype).float()
        out = out + xs[i].double() @ w.abs().double()
    return 2 * k * 2.0**-24 * out


def check_kernels(torch, gen, cases=None):
    """Correctness at every shape, dtype and demand; raises on any miss.
    ``cases`` is a list of (kernel name, M); by default each kernel at its
    phase-2 M."""
    from repro_torch.kernels import qsq, ref

    if cases is None:
        cases = [(name, m) for name, (_, m, _, _) in KERNELS.items()]
    n_checks = 0
    for k, n in SHAPES:
        for x_dtype in (torch.bfloat16, torch.float32):
            for demand in (0, 1, 2):
                for name, m in cases:
                    masked = KERNELS[name][0]
                    x, planes, scales, mask = operands(torch, m, k, n, gen, x_dtype, demand)
                    kw = dict(group_size=GROUP, sign_mag=True, plane_major=True,
                              demand_drop=demand)
                    fn = getattr(qsq, name)
                    if not masked:
                        mask = torch.full((m,), ref.MASK_VARIANTS[demand], dtype=torch.int32,
                                          device="cuda")
                    got = fn(x, mask, planes, scales, **kw) if masked else fn(
                        x, planes, scales, **kw)
                    torch.cuda.synchronize()
                    want = ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw)
                    err = (got.double() - want.double()).abs()
                    bound = f32_bound(torch, x, mask, planes, scales, demand)
                    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
                        raise AssertionError(
                            f"{name} K={k} N={n} {x_dtype} demand={demand}: max err "
                            f"{float(err.max()):.3e} exceeds the f32 bound")
                    n_checks += 1
                    if masked:
                        # bit-identity: each row equals the unmasked kernel on
                        # planes truncated to the row's drop ...
                        plain_fn = getattr(qsq, name.replace("_masked", ""))
                        for drop, code_mask in enumerate(ref.MASK_VARIANTS):
                            rows = mask == code_mask
                            if drop < demand or not bool(rows.any()):
                                continue
                            trunc = planes.clone()
                            trunc[3 - drop:] = 0
                            base = plain_fn(x, trunc, scales, group_size=GROUP, sign_mag=True,
                                            plane_major=True)
                            if not torch.equal(got[rows], base[rows]):
                                raise AssertionError(f"{name} K={k} N={n} {x_dtype}: masked "
                                                     f"rows at drop {drop} differ from the "
                                                     f"unmasked kernel on truncated planes")
                        # ... and demand routing changes no bit
                        full = fn(x, mask, planes, scales, group_size=GROUP, sign_mag=True,
                                  plane_major=True, demand_drop=0)
                        if demand and not torch.equal(got, full):
                            raise AssertionError(f"{name} K={k} N={n} {x_dtype}: demand "
                                                 f"{demand} routing changed the output")
                        n_checks += 2
    torch.cuda.synchronize()
    return n_checks


def time_kernels(torch, gen, flush):
    """Per kernel, summed over the five smollm shapes (bf16 x, all planes):
    kernel, plain-version and library times and the bound; the masked
    kernels also at demand_drop = 2 (one plane read, one variant decoded)."""
    rows = {}
    for name, (masked, m, source, replaces) in KERNELS.items():
        for demand in (0, 2) if masked else (0,):
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_s=0.0, ops_s=0.0,
                       bound=0.0)
            for k, n in SHAPES:
                b_s, o_s, ms, plain_ms, lib_ms = time_one(torch, gen, flush, name, masked, m,
                                                          k, n, demand)
                tag = f" d={demand}" if masked else ""
                say(f"  {name:18s}{tag} K={k:5d} N={n:5d} M={m:2d}: kernel {ms * 1e3:8.2f} us  "
                    f"plain {plain_ms * 1e3:8.2f} us  torch.matmul {lib_ms * 1e3:8.2f} us  "
                    f"bound {max(b_s, o_s) * 1e6:6.2f} us ({'bytes' if b_s >= o_s else 'ops'})")
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["library_ms"] += lib_ms
                tot["bytes_s"] += b_s
                tot["ops_s"] += o_s
                tot["bound"] += max(b_s, o_s)
            row = dict(
                name=name, route="cuda", source=source, replaces=replaces,
                ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound"] * 1e3,
                bound_by="bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
                library_ms=tot["library_ms"])
            if demand:
                say(f"  {name} at demand_drop={demand}, summed: kernel {row['ms']:.4f} ms, "
                    f"torch.matmul {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
            else:
                rows[name] = row
    for name, row in rows.items():
        say(f"  {name} summed: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"torch.matmul {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return rows


def time_one(torch, gen, flush, name, masked, m, k, n, demand):
    """One shape: (bytes bound s, ops bound s, kernel ms, plain ms, torch.matmul ms).
    The bound counts the 3 - demand planes the call must read."""
    from repro_torch.kernels import qsq, ref

    x, planes, scales, mask = operands(torch, m, k, n, gen, torch.bfloat16, demand)
    kw = dict(group_size=GROUP, sign_mag=True, plane_major=True, demand_drop=demand)
    fn = getattr(qsq, name)
    if masked:
        def kern():
            return fn(x, mask, planes, scales, **kw)

        def plain():
            return ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw)
    else:
        def kern():
            return fn(x, planes, scales, **kw)

        def plain():
            return ref.qsq_matmul_ref(x, planes, scales, GROUP, sign_mag=True,
                                      plane_major=True)
    w = ref.qsq_dequant_ref(planes, scales, GROUP, sign_mag=True, plane_major=True,
                            n_planes=3 - demand).to(torch.bfloat16)

    def library():
        return torch.matmul(x, w)

    ms = time_ms(torch, kern, flush)
    plain_ms = time_ms(torch, plain, flush)
    lib_ms = time_ms(torch, library, flush)
    nbytes = (m * k * 2 + (3 - demand) * (k // 32) * n * 4 + (k // GROUP) * n * 4 + m * n * 4
              + (m * 4 if masked else 0))
    ops = 2 * m * k * n
    return nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"], ms, plain_ms, lib_ms


# --------------------------------------------------------------------------
# Phase 3: the full-width main path
# --------------------------------------------------------------------------
def serve_full_width(torch, workdir: Path, cfg, device="cuda"):
    from repro_torch import api
    from repro_torch.kernels import dispatch, qsq, ref
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    model = Model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model.param_descs(), gen, device=device)
    # lo truncates three quarters of the packed leaves, so the most sensitive
    # ones serve untiered through the unmasked kernels at every tier
    tiers = api.QualitySpec((api.QualityTier("hi", 0, 0.0), api.QualityTier("mid", 1, 0.5),
                             api.QualityTier("lo", 2, 0.75)))

    qsq.reset_launches()
    ref.calls.clear()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    art = api.compress(model, params, tiers=tiers, device=device)
    path = art.save(workdir / "smollm_135m.edge.npz")
    t_save = time.perf_counter() - t0
    art = api.load(path, verify=True)
    if art.plane_damage:
        raise AssertionError(f"fresh artifact failed its checksums: {art.plane_damage}")
    eng = art.engine(quality="mid", batch_slots=8, device=device)
    t_load = time.perf_counter() - t0 - t_save

    admit_ms, decode_ms = [], []
    orig_admit, orig_step = eng._admit, eng._cont_step

    def timed_admit(*a):
        s = time.perf_counter()
        cache, first = orig_admit(*a)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - s) * 1e3)
        return cache, first

    def timed_step(*a):
        s = time.perf_counter()
        nxt, cache = orig_step(*a)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - s) * 1e3)
        return nxt, cache

    eng._admit, eng._cont_step = timed_admit, timed_step
    rng = torch.Generator().manual_seed(1)
    lengths = [5 + (59 * i) // 11 for i in range(12)]  # 5 .. 64
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist() for n in lengths]
    names = ["hi", "mid", "lo"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rids = [eng.submit(p, max_new=16, quality=names[i % 3]) for i, p in enumerate(prompts[:8])]
    for p_i in range(8, 12):  # later arrivals join the running decode
        eng.step()
        eng.step()
        rids.append(eng.submit(prompts[p_i], max_new=16, quality=names[p_i % 3]))
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1

    launches = dict(qsq.launches)
    stats = eng.stream_stats()
    for r in rids:
        st = eng.poll(r)
        if st.finish_reason is None or st.finish_reason.value != "done" or len(st.tokens) != 16:
            raise AssertionError(f"request {r} ended {st.finish_reason} with "
                                 f"{len(st.tokens)} tokens")
        if not all(0 <= t < cfg.vocab for t in st.tokens):
            raise AssertionError(f"request {r} emitted out-of-vocab tokens")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if sum(ref.calls.values()):
        raise AssertionError(f"plain versions ran on the main path: {dict(ref.calls)}")
    if 4 * dispatch.traffic["plane_words_read"] != stats["bytes_read"]:
        raise AssertionError("per-call dispatch traffic disagrees with the byte meter")
    tokens = stats["tokens"]
    say(f"  artifact: {path.stat().st_size / 2**20:.1f} MiB, compress+save "
        f"{t_save:.1f} s, load(verify)+engine {t_load:.1f} s, {eng.n_packed_leaves} packed "
        f"leaves")
    say(f"  served {len(rids)} requests, {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tokens/s")
    say(f"  decode step: median {statistics.median(decode_ms):.2f} ms over {len(decode_ms)} "
        f"steps; admission (prefill M=64 + insert): median {statistics.median(admit_ms):.2f} "
        f"ms over {len(admit_ms)}")
    say(f"  kernels launched: {launches}; plain versions called: {sum(ref.calls.values())}")
    say(f"  dispatch routes: {dict(dispatch.counters)}")
    say(f"  stream_stats: bytes/token {stats['bytes_per_token']:.1f}, read_frac "
        f"{stats['read_frac']:.4f} (= per-call dispatch traffic "
        f"{4 * dispatch.traffic['plane_words_read']} B)")
    eng._admit, eng._cont_step = orig_admit, orig_step
    profile_decode(torch, eng, prompts[:8], names)
    profile_admission(torch, eng, prompts[11], "mid")
    return launches, path


def kernel_of(key: str) -> str | None:
    """The wrapper behind a profiled kernel name, or None."""
    if "packed_mma_kernel<" in key:  # <MT, NT, NP, MASKED, ...>: MT 1 = GEMV, 4 = GEMM
        mt, _, _, masked = key.split("packed_mma_kernel<")[1].split(",")[:4]
        base = "qsq_matvec" if mt.strip() == "1" else "qsq_matmul"
        return base + ("_masked" if masked.strip() == "true" else "")
    for part, base in (("qsq_gemv_kernel<", "qsq_matvec"), ("qsq_gemm_kernel<", "qsq_matmul")):
        if part in key:
            return base + ("_masked" if key.split(part)[1].split(">")[0].endswith("true")
                           else "")
    return None


def device_kernels(prof):
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profile_admission(torch, eng, prompt, quality):
    """Device time by kernel over one admission (a single-slot prefill at
    M = 64 and its cache insert), K4's share of it and the launches."""
    from torch.profiler import ProfilerActivity, profile

    orig = eng._admit
    box = {}

    def profiled(*a):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = orig(*a)
            torch.cuda.synchronize()
            box["wall_us"] = (time.perf_counter() - t0) * 1e6
        box["prof"] = prof
        return out

    eng._admit = profiled
    try:
        eng.submit(prompt, max_new=2, quality=quality)
        eng.step()
    finally:
        eng._admit = orig
    eng.run_until_drained()
    kern = device_kernels(box["prof"])
    busy = sum(t for _, t, _ in kern)
    by = {}
    for key, t, n in kern:
        name = kernel_of(key)
        if name:
            by[name] = (by.get(name, (0.0, 0))[0] + t, by.get(name, (0.0, 0))[1] + n)
    k4_us, k4_n = by.get("qsq_matmul_masked", (0.0, 0))
    say(f"  profile of one admission ({len(prompt)}-token prompt, M=64): wall "
        f"{box['wall_us'] / 1e3:.2f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / box['wall_us']:.1f}% of wall), {sum(n for _, _, n in kern)} launches; "
        f"K4 {k4_us / 1e3:.3f} ms = {100 * k4_us / max(busy, 1e-9):.1f}% of device time in "
        f"{k4_n} launches")
    for name, (t, n) in sorted(by.items()):
        say(f"    {name:18s} {t / 1e3:7.3f} ms  {n:4d} launches  ({t / max(n, 1):.1f} us each)")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:6]:
        say(f"    {t / 1e3:7.3f} ms  {n:5d} launches  {name[:90]}")


def profile_decode(torch, eng, prompts, names, steps=4):
    """Device time by kernel over ``steps`` full-batch decode steps (after
    the launch counts were read), and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.submit(p, max_new=steps + 4, quality=names[i % 3])
    eng.step()  # admits every prompt, then one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run_until_drained()
    kern = device_kernels(prof)
    busy = sum(t for _, t, _ in kern)
    say(f"  profile of {steps} decode steps at 8 live slots: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step "
        f"({100 * busy / wall_us:.1f}% of wall), "
        f"{sum(n for _, _, n in kern) // steps} launches/step")
    by = {}
    for key, t, n in kern:
        name = kernel_of(key)
        if name:
            by[name] = (by.get(name, (0.0, 0))[0] + t, by.get(name, (0.0, 0))[1] + n)
    for name, (t, n) in sorted(by.items()):
        say(f"    {name:18s} {t / steps / 1e3:7.3f} ms/step = {100 * t / max(busy, 1e-9):5.1f}% "
            f"of device time, {n // steps:4d} launches/step ({t / max(n, 1):.1f} us each)")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:8]:
        say(f"    {t / steps / 1e3:7.3f} ms/step  {n // steps:5d} launches/step  {name[:90]}")


# --------------------------------------------------------------------------
# Phase 4: the card against the CPU at the test config
# --------------------------------------------------------------------------
def d64_model_params(torch):
    """The 2-layer d64 test config (f32) and its parameters on the CPU,
    drawn with numpy from seed 0."""
    import numpy as np

    from repro_torch.configs.base import ArchConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.api import Model
    from repro_torch.models.base import is_desc
    from repro_torch.tree import tree_map

    cfg = ArchConfig(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv=2, d_ff=128, vocab=256, dtype=torch.float32, remat=False)
    model = Model(cfg)
    rng = np.random.default_rng(0)

    def draw(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return model, params_from_numpy(tree_map(draw, model.param_descs(), is_leaf=is_desc), "cpu")


def card_vs_cpu(torch, workdir: Path, card="cuda"):
    import numpy as np

    from repro_torch import api
    from repro_torch.models.base import init_params

    model, params = d64_model_params(torch)
    path = api.compress(model, params, device="cpu").save(workdir / "d64.edge.npz")
    art = api.load(path)
    prompts = [[5, 9, 2], [17], [3, 3, 3, 3, 8, 1], [250, 1], [7] * 8, [1, 2, 3, 4]]
    quals = ["hi", "mid", "lo", "mid", "lo", "hi"]
    toks = {}
    logits = {}
    for dev in ("cpu", card):
        eng = art.engine(quality="mid", batch_slots=4, max_prompt=8, max_len=32, device=dev)
        toks[dev] = eng.generate(prompts[:4], max_new=8, qualities=quals[:4])
        rids = [eng.submit(p, max_new=6, quality=q) for p, q in zip(prompts, quals)]
        eng.run_until_drained()
        toks[dev] += [eng.poll(r).tokens for r in rids]
        tp, _ = art.serve_params("hi", per_request=True, device=dev)
        lens = torch.tensor([3, 8, 5], dtype=torch.int32)
        t = torch.tensor(np.random.default_rng(2).integers(0, 256, (3, 8)), dtype=torch.int32)
        tiers = torch.tensor([0, 2, 1], dtype=torch.int32)
        cache = init_params(model.cache_descs(3, 16), device=dev)
        cache, last = model.prefill(tp, cache, t.to(dev), lens.to(dev), tiers.to(dev), 0)
        out = [last]
        cur = torch.argmax(last, -1).to(torch.int32)[:, None]
        for _ in range(3):
            lg, cache = model.decode(tp, cache, {"tokens": cur.to(dev), "tiers": tiers.to(dev),
                                                 "demand": 0})
            out.append(lg[:, -1])
            cur = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None].cpu()
        logits[dev] = torch.stack([o.cpu() for o in out])
    if toks["cpu"] != toks[card]:
        raise AssertionError(f"greedy tokens differ between card and CPU:\n{toks}")
    diff = (logits[card] - logits["cpu"]).abs()
    tol = 1e-4 + 1e-4 * logits["cpu"].abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"card logits off the CPU's by {float(diff.max()):.3e}")
    say(f"  {sum(len(t) for t in toks[card])} greedy tokens identical on card and CPU; "
        f"logits max |diff| {float(diff.max()):.3e} (tolerance 1e-4 abs + 1e-4 rel)")


# --------------------------------------------------------------------------
# Phase 5: the encoder K5 against its plain version
# --------------------------------------------------------------------------
def grad_like(torch, k, n, gen, dtype=None):
    """Gradient-sized values (~1e-3) with a few all-zero groups."""
    w = torch.randn((k, n), generator=gen, device="cuda") * 1e-3
    w[: min(k, 64), :3] = 0.0
    return w if dtype is None else w.to(dtype)


def check_quantize(torch, gen) -> tuple[int, float]:
    """Codes and scales bit for bit; returns (checks, max |kernel - plain|)."""
    from repro_torch.kernels import pack_weight, qsq, ref

    cases = [(k, n, g, phi, dt) for k, n, g in K5_SHAPES
             for phi in (1, 2, 4) for dt in (torch.float32, torch.bfloat16)]
    cases += [(k, n, g, phi, dt) for k, n in ((576, 1536), (1536, 1000), (30, 4097))
              for g in (2, 16, 32, 64) if k % g == 0
              for phi in (1, 2, 4) for dt in (torch.float32, torch.bfloat16)]
    worst = 0.0
    for k, n, g, phi, dt in cases:
        w = grad_like(torch, k, n, gen, dt)
        codes, scales = qsq.qsq_quantize(w, group_size=g, phi=phi)
        torch.cuda.synchronize()
        want_c, want_s = ref.qsq_quantize_ref(w, g, phi)
        worst = max(worst, float((scales - want_s).abs().max()),
                    float((codes.int() - want_c.int()).abs().max()))
        if not (torch.equal(codes, want_c) and torch.equal(scales, want_s)):
            raise AssertionError(f"qsq_quantize K={k} N={n} G={g} phi={phi} {dt}: "
                                 f"{int((codes != want_c).sum())} codes and "
                                 f"{int((scales != want_s).sum())} scales differ from the "
                                 f"plain version")
    # the JAX package's own end-to-end use: pack_weight -> qsq_matmul
    for k, n in SHAPES:
        w = torch.randn((k, n), generator=gen, device="cuda")
        x = torch.randn((64, k), generator=gen, device="cuda")
        planes, scales = pack_weight(w, group_size=GROUP)
        got = qsq.qsq_matmul(x, planes, scales, group_size=GROUP)
        want = ref.qsq_matmul_ref(x, planes, scales, GROUP)
        wd = ref.qsq_dequant_ref(planes, scales, GROUP)
        bound = 2 * k * 2.0**-24 * (x.abs().double() @ wd.abs().double())
        if not bool(((got.double() - want.double()).abs() <= bound).all()):
            raise AssertionError(f"pack_weight -> qsq_matmul K={k} N={n} off the f32 bound")
    return len(cases) + len(SHAPES), worst


def time_quantize(torch, gen, flush) -> dict:
    """K5 and its plain version, cold, at the 11 train-step shapes (f32)."""
    from repro_torch.kernels import qsq, ref

    tot = dict(ms=0.0, plain_ms=0.0, bytes_s=0.0, ops_s=0.0)
    for k, n, g in K5_SHAPES:
        w = grad_like(torch, k, n, gen)
        ms = time_ms(torch, lambda: qsq.qsq_quantize(w, group_size=g, phi=4), flush)
        plain_ms = time_ms(torch, lambda: ref.qsq_quantize_ref(w, g, 4), flush, runs=5)
        nbytes = k * n * 4 + k * n + (k // g) * n * 4  # read f32 w; write codes, scales
        ops = 3 * k * n + (k // g) * n  # |w| and + per value, one division each; alpha
        b_s, o_s = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
        say(f"  qsq_quantize K={k:5d} N={n:6d} G={g:2d}: kernel {ms * 1e3:8.2f} us  "
            f"plain {plain_ms * 1e3:9.2f} us  bound {max(b_s, o_s) * 1e6:7.2f} us "
            f"({'bytes' if b_s >= o_s else 'ops'})")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bytes_s"] += b_s
        tot["ops_s"] += o_s
    name, source, replaces = K5
    return dict(name=name, route="cuda", source=source, replaces=replaces, ms=tot["ms"],
                plain_ms=tot["plain_ms"],
                bound_ms=max(tot["bytes_s"], tot["ops_s"]) * 1e3,
                bound_by="bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
                library_ms=None)


# --------------------------------------------------------------------------
# Phase 6: full-width training with QSQ gradient compression
# --------------------------------------------------------------------------
def train_full_width(torch, workdir: Path, cfg, steps=6, every=3, device="cuda"):
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.data.pipeline import LMDataConfig, lm_batch
    from repro_torch.kernels import qsq, ref
    from repro_torch.models.api import Model
    from repro_torch.optim import AdamWConfig, GradCompressionConfig
    from repro_torch.train.state import train_state_descs
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    model = Model(cfg)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
    cc = GradCompressionConfig(enabled=True)
    ckpt_dir = workdir / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(ckpt):
        tc = TrainerConfig(total_steps=steps, log_every=1, opt=AdamWConfig(lr=1e-3),
                           compression=cc, checkpoint=ckpt)
        return Trainer(model, tc, lambda step: lm_batch(data, step), device=device)

    per_step = []

    def hook(step, state, metrics):
        per_step.append((step, qsq.launches["qsq_quantize"], metrics["grad_wire_bytes"]))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tr_a = trainer(CheckpointConfig(directory=str(ckpt_dir), every_steps=every))
        state0, _ = tr_a.init_state()
        torch.cuda.synchronize()
        qsq.reset_launches()
        ref.calls.clear()
        state_a, last = tr_a.run(state0, 0, step_hook=hook)
        del state0
        mgr = CheckpointManager(tr_a.cfg.checkpoint)
        state3, meta = mgr.restore(train_state_descs(model, cc), step=every, device=device)
        tr_b = trainer(None)
        state_b, last_b = tr_b.run(state3, int(meta["data_state"]["step"]), step_hook=hook)
        torch.cuda.synchronize()
        launches = dict(qsq.launches)
        plain = dict(ref.calls)
    finally:
        torch.use_deterministic_algorithms(False)

    losses = [m["loss"] for m in tr_a.metrics_log]
    losses_b = [m["loss"] for m in tr_b.metrics_log]
    if last != steps or last_b != steps or not all(map(math.isfinite, losses + losses_b)):
        raise AssertionError(f"training ended at {last}/{last_b} with losses {losses} "
                             f"{losses_b}")
    counts = [c for _, c, _ in per_step]
    if counts != [len(K5_SHAPES) * (i + 1) for i in range(len(counts))] or \
            len(counts) != 2 * steps - every:
        raise AssertionError(f"K5 launches per step are not {len(K5_SHAPES)}: {per_step}")
    if plain.get("qsq_quantize_ref", 0) or sum(plain.values()):
        raise AssertionError(f"plain versions ran on the training path: {plain}")
    if {b for _, _, b in per_step} != {float(WIRE_BYTES)}:
        raise AssertionError(f"grad_wire_bytes {per_step} != {WIRE_BYTES}")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(state_a), tree_leaves(state_b),
                                                 strict=True))
    if not same or losses_b != losses[every:]:
        raise AssertionError(f"resumed run differs from the continuous one: losses {losses} "
                             f"vs {losses_b}")
    step_ms = [m["sec_per_step"] * 1e3 for m in tr_a.metrics_log + tr_b.metrics_log]
    say(f"  {steps} steps at batch 8 x seq 128, then steps {every}..{steps - 1} again from "
        f"the step-{every} checkpoint: losses {[round(x, 4) for x in losses]}")
    say(f"  resumed run equals the continuous one bit for bit "
        f"({len(tree_leaves(state_a))} state leaves, deterministic algorithms on)")
    say(f"  K5 launches: {launches.get('qsq_quantize', 0)} ({len(K5_SHAPES)} per step); plain "
        f"encoder calls: {plain.get('qsq_quantize_ref', 0)}; grad_wire_bytes "
        f"{per_step[0][2]:.0f} per step")
    say(f"  step: median {statistics.median(step_ms):.2f} ms over {len(step_ms)} steps "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f})")
    ckpt_bytes = mgr.step_path(steps).stat().st_size
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    say(f"  checkpoint: {ckpt_bytes / 2**30:.2f} GiB per step file")
    profile_train_step(torch, tr_b, state_b, data, statistics.median(step_ms))
    return launches


def profile_train_step(torch, trainer, state, data, median_ms):
    """Device time by kernel over one more train step, its busy share, and
    K5's share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import lm_batch

    batch = lm_batch(data, 0, trainer.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = trainer.step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in kern)
    k5 = sum(t for name, t, _ in kern if "qsq_quantize" in name)
    say(f"  profile of one train step: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall); K5 {k5 / 1e3:.3f} ms = "
        f"{100 * k5 / busy:.2f}% of device time, {100 * k5 / 1e3 / median_ms:.2f}% of the "
        f"median step")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:8]:
        say(f"    {t / 1e3:8.3f} ms  {n:5d} launches  {name[:90]}")
    ops = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    say(f"  host: {sum(n for _, _, n in kern)} kernel launches; busiest host ops (self time):")
    for name, t, n in sorted(ops, key=lambda r: -r[1])[:5]:
        say(f"    {t / 1e3:8.3f} ms  {n:5d} calls  {name[:90]}")


# --------------------------------------------------------------------------
# Phase 7: training on the card against the CPU at the test config
# --------------------------------------------------------------------------
def train_card_vs_cpu(torch, card="cuda", steps=3):
    import numpy as np

    from repro_torch.configs.base import ArchConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import LMDataConfig, lm_batch
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params, is_desc
    from repro_torch.optim import AdamWConfig, GradCompressionConfig, compress_grads
    from repro_torch.train.state import train_state_descs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = ArchConfig(name="smollm-bench", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv=2, d_ff=128, vocab=256, dtype=torch.float32, remat=False)
    model = Model(cfg)
    cc = GradCompressionConfig(enabled=True)
    rng = np.random.default_rng(0)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(d.shape, np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    descs = train_state_descs(model, cc)
    start = init_params(descs, device="cpu")
    start = start._replace(params=params_from_numpy(
        tree_map(draw, descs.params, is_leaf=is_desc), "cpu"))
    data = LMDataConfig(vocab=256, seq_len=16, global_batch=4)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3), cc, total_steps=steps)
    losses, grads, dec = {}, {}, {}
    for dev in ("cpu", card):
        state = tree_map(lambda t, d=dev: t.to(d), start)
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        model.loss(params, lm_batch(data, 0, dev)).backward()
        with torch.no_grad():
            g = tree_map(lambda p: p.grad, params)
            d, _, _ = compress_grads(g, state.err, cc)
        grads[dev] = [t.cpu().double() for t in tree_leaves(g)]
        dec[dev] = [t.cpu().double() for t in tree_leaves(d)]
        losses[dev] = []
        for s in range(steps):
            state, m = step_fn(state, lm_batch(data, s, dev))
            losses[dev].append(float(m["loss"]))
    np.testing.assert_allclose(losses[card], losses["cpu"], rtol=1e-4)
    # f32 gradients of this model lie within ~5e-5 of each leaf's max of
    # their f64 values, so two f32 orders agree within 2e-4 of it; an
    # encoded value inherits that through its scale unless its code flips
    # at a nearest-level near-tie, allowed at 0.1% of the encoded values
    compressed = [e.dim() > 0 for e in tree_leaves(start.err)]
    n_off = n_enc = 0
    for a, b, c, e, enc in zip(grads["cpu"], grads[card], dec["cpu"], dec[card], compressed,
                               strict=True):
        if (a - b).abs().max() > 2e-4 * a.abs().max():
            raise AssertionError(f"raw gradients differ by {float((a - b).abs().max()):.3e}")
        off = int(((c - e).abs() > 2e-4 * c.abs().max()).sum())
        if enc:
            n_off, n_enc = n_off + off, n_enc + c.numel()
        elif off:
            raise AssertionError(f"an uncompressed gradient leaf differs at {off} values")
    if n_off > 1e-3 * n_enc:
        raise AssertionError(f"compressed gradients differ at {n_off} of {n_enc} values")
    say(f"  losses card {losses[card]} vs CPU {losses['cpu']} (rtol 1e-4); step-0 gradients "
        f"within 2e-4 of each leaf's max, the compressed ones at all but {n_off} of {n_enc} "
        f"values (allowed 0.1%: near-ties)")


# --------------------------------------------------------------------------
# Phase 8: speculative and static serving at full width
# --------------------------------------------------------------------------
W_VERIFY = 5  # the verify window: the anchor and k = 4 drafts
M_VERIFY = M_GEMV * W_VERIFY  # 8 slots x (k + 1) = 40 rows
MAX_NEW = 16


def check_verify_rows(torch, gen) -> int:
    """Every row of a verify window (K4 / K3 at M = 40) equals the decode
    row of the same x (K2 / K1 at M = 8) bit for bit: five shapes, bf16 and
    f32 x, demand 0 and 2.  Row b * W + j of the window is lane b's
    position j, as ``PackedWeight.matmul`` flattens (B, W)."""
    from repro_torch.kernels import qsq, ref

    n = 0
    for k, nn in SHAPES:
        for x_dtype in (torch.bfloat16, torch.float32):
            for demand in (0, 2):
                x, planes, scales, _ = operands(torch, M_VERIFY, k, nn, gen, x_dtype, demand)
                variants = torch.tensor(ref.MASK_VARIANTS[demand:], dtype=torch.int32,
                                        device="cuda")
                lane = variants[torch.randint(0, len(variants), (M_GEMV,), generator=gen,
                                              device="cuda")]
                mask = lane.repeat_interleave(W_VERIFY).contiguous()
                kw = dict(group_size=GROUP, sign_mag=True, plane_major=True,
                          demand_drop=demand)
                win_m = qsq.qsq_matmul_masked(x, mask, planes, scales, **kw)
                win = qsq.qsq_matmul(x, planes, scales, group_size=GROUP, sign_mag=True,
                                     plane_major=True)
                for j in range(W_VERIFY):
                    xj = x[j::W_VERIFY].contiguous()
                    dec_m = qsq.qsq_matvec_masked(xj, lane, planes, scales, **kw)
                    dec = qsq.qsq_matvec(xj, planes, scales, group_size=GROUP, sign_mag=True,
                                         plane_major=True)
                    if not (torch.equal(win_m[j::W_VERIFY], dec_m)
                            and torch.equal(win[j::W_VERIFY], dec)):
                        raise AssertionError(
                            f"verify rows differ from decode rows: K={k} N={nn} {x_dtype} "
                            f"demand={demand} position {j}: masked max |diff| "
                            f"{float((win_m[j::W_VERIFY] - dec_m).abs().max()):.3e}, "
                            f"unmasked {float((win[j::W_VERIFY] - dec).abs().max()):.3e}")
                    n += 2
    torch.cuda.synchronize()
    return n


def time_new_shapes(torch, gen, m_static: int):
    """K4 / K3 at the verify window and K3 at the static prefill, summed over
    the five shapes (bf16 x, all planes, cold L2)."""
    flush = Flush(torch)
    for name, m in (("qsq_matmul_masked", M_VERIFY), ("qsq_matmul", M_VERIFY),
                    ("qsq_matmul", m_static)):
        tot = [0.0] * 5
        for k, n in SHAPES:
            b_s, o_s, ms, plain_ms, lib_ms = time_one(torch, gen, flush, name, KERNELS[name][0],
                                                      m, k, n, 0)
            for i, v in enumerate((ms, plain_ms, lib_ms, max(b_s, o_s) * 1e3)):
                tot[i] += v
            say(f"  {name:18s} K={k:5d} N={n:5d} M={m:3d}: kernel {ms * 1e3:8.2f} us  "
                f"torch.matmul {lib_ms * 1e3:8.2f} us  bound {max(b_s, o_s) * 1e6:6.2f} us")
        say(f"  {name} at M={m}, summed: kernel {tot[0]:.4f} ms, plain {tot[1]:.4f} ms, "
            f"torch.matmul {tot[2]:.4f} ms, bound {tot[3]:.4f} ms")
    del flush


def _stream(torch, eng, prompts, quals, spec, speculate):
    """12 requests, 8 up front and 4 more joining the running decode, as in
    phase 3; ``spec[i]`` requests speculate with ``speculate``."""
    eng.reset_stream()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW, quality=q, speculate=speculate if sp else None)
            for p, q, sp in zip(prompts[:8], quals, spec, strict=False)]
    for i in range(8, len(prompts)):
        eng.step()
        eng.step()
        rids.append(eng.submit(prompts[i], max_new=MAX_NEW, quality=quals[i],
                               speculate=speculate if spec[i] else None))
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = []
    for r in rids:
        st = eng.poll(r)
        if st.finish_reason is None or st.finish_reason.value != "done" or \
                len(st.tokens) != MAX_NEW:
            raise AssertionError(f"request {r} ended {st.finish_reason} with "
                                 f"{len(st.tokens)} tokens")
        out.append(st.tokens)
    return out, eng.stream_stats(), wall


def speculative_and_static(torch, gen, path: Path, cfg) -> dict:
    from repro_torch import api
    from repro_torch.kernels import dispatch, qsq, ref
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    rng = torch.Generator().manual_seed(1)
    lengths = [5 + (59 * i) // 11 for i in range(12)]  # 5 .. 64
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist() for n in lengths]
    m_static = M_GEMV * max(lengths[:8])
    n = check_kernels(torch, gen, [("qsq_matmul_masked", M_VERIFY), ("qsq_matmul", M_VERIFY),
                                   ("qsq_matmul", m_static)])
    say(f"  {n} checks at the new shapes (K4/K3 at M={M_VERIFY}, K3 at M={m_static}) passed: "
        f"f32 bound, masked == truncated and demand-routed == masked bit for bit")
    n = check_verify_rows(torch, gen)
    say(f"  verify rows == decode rows bit for bit: {n} checks (K4 vs K2 and K3 vs K1, "
        f"5 shapes, bf16 and f32, demand 0 and 2, every window position)")
    time_new_shapes(torch, gen, m_static)

    art = api.load(path, verify=True)
    eng = art.engine(quality="mid", batch_slots=8, device="cuda")
    quals = ["hi" if i % 2 == 0 else "mid" for i in range(12)]
    spec = [(i // 2) % 2 == 0 for i in range(12)]  # half of each tier speculates
    sc = api.SpecConfig("lo", k=W_VERIFY - 1)
    plain_toks, plain_stats, plain_wall = _stream(torch, eng, prompts, quals, spec, None)

    ticks = []
    orig_step, orig_verify = eng._cont_step, eng._verify

    def counted(fn, kind):
        """Record each draft tick's and each verify's launches (and the
        verify's rows, M = 8 x window)."""
        def wrapped(*a):
            before = dict(qsq.launches)
            draft = dispatch.traffic["phase:draft:plane_words_read"]
            out = fn(*a)
            if kind == "verify" or dispatch.traffic["phase:draft:plane_words_read"] > draft:
                m = a[2].numel() if kind == "verify" else a[2].shape[0]
                ticks.append((kind, m, {k: v - before.get(k, 0)
                                        for k, v in qsq.launches.items()}))
            return out
        return wrapped

    eng._cont_step, eng._verify = counted(orig_step, "draft"), counted(orig_verify, "verify")
    qsq.reset_launches()
    ref.calls.clear()
    dispatch.reset_counters()
    try:
        spec_toks, stats, spec_wall = _stream(torch, eng, prompts, quals, spec, sc)
    finally:
        eng._cont_step, eng._verify = orig_step, orig_verify
    launches = dict(qsq.launches)
    plain_calls = sum(ref.calls.values())
    words = eng._session.phase_words
    tr = dispatch.traffic
    if spec_toks != plain_toks:
        bad = [i for i, (a, b) in enumerate(zip(spec_toks, plain_toks, strict=True)) if a != b]
        raise AssertionError(f"speculative tokens differ from plain decode for requests {bad}")
    if stats["drafted"] == 0:
        raise AssertionError("no request drafted")
    if plain_calls:
        raise AssertionError(f"plain versions ran on the speculative path: {dict(ref.calls)}")
    n_draft = sum(1 for kind, _, _ in ticks if kind == "draft")
    n_verify = sum(1 for kind, _, _ in ticks if kind == "verify")
    n_full = sum(1 for kind, m, _ in ticks if kind == "verify" and m == M_VERIFY)
    if not n_draft or not n_full:
        raise AssertionError(f"{n_draft} draft ticks and {n_full} verifies at M={M_VERIFY}")
    for kind, m, d in ticks:
        # a verify window clamped near max_new to M <= 16 rows is a GEMV call
        want = "qsq_matmul_masked" if m > 16 else "qsq_matvec_masked"
        if not d.get(want):
            raise AssertionError(f"a {kind} call at M={m} launched no {want}: {d}")
    for phase in ("draft", "verify"):
        if (tr[f"phase:{phase}:plane_words_read"], tr[f"phase:{phase}:plane_words_full"]) != \
                tuple(words[phase]):
            raise AssertionError(f"phase {phase} traffic {dict(tr)} != meter {words[phase]}")
    if 4 * tr["plane_words_read"] != stats["bytes_read"]:
        raise AssertionError("per-call dispatch traffic disagrees with the byte meter")
    say(f"  12 requests x {MAX_NEW} tokens on 8 slots (hi/mid, half speculating with "
        f"SpecConfig('lo', {sc.k})): tokens identical to the same requests served plainly")
    say(f"  drafted {stats['drafted']}, accepted {stats['accepted']} (rate "
        f"{stats['acceptance_rate']:.4f}); bytes/token {stats['bytes_per_token']:.1f} "
        f"speculative vs {plain_stats['bytes_per_token']:.1f} plain")
    say(f"  {n_draft} draft ticks (each launched K2), {n_verify} verifies ({n_full} at "
        f"M={M_VERIFY}; each at M > 16 launched K4, the rest K2); kernels launched: "
        f"{launches}; plain versions called: {plain_calls}")
    say(f"  phase words (per call == meter): draft {words['draft'][0]} of {words['draft'][1]}, "
        f"verify {words['verify'][0]} of {words['verify'][1]}")
    say(f"  tokens/s: speculative {stats['tokens'] / spec_wall:.1f} ({spec_wall:.3f} s), plain "
        f"{plain_stats['tokens'] / plain_wall:.1f} ({plain_wall:.3f} s)")
    profile_spec_round(torch, eng, prompts[:8], sc)

    echo_tiers = api.QualitySpec((api.QualityTier("hi", 0, 0.0),
                                  api.QualityTier("echo", 0, 0.0)))
    echo = api.EdgeArtifact(wire=art.wire, arch_config=art.arch_config, tiers=echo_tiers,
                            rank=art.rank).engine(quality="hi", batch_slots=8, device="cuda")
    e_plain, _, _ = _stream(torch, echo, prompts[:8], ["hi"] * 8, [True] * 8, None)
    e_spec, e_stats, _ = _stream(torch, echo, prompts[:8], ["hi"] * 8, [True] * 8,
                                 api.SpecConfig("echo", k=W_VERIFY - 1))
    if e_spec != e_plain or e_stats["drafted"] == 0 or e_stats["acceptance_rate"] != 1.0:
        raise AssertionError(f"echo ladder: acceptance {e_stats['acceptance_rate']}, tokens "
                             f"{'identical' if e_spec == e_plain else 'differ'}")
    say(f"  echo ladder: {e_stats['accepted']} of {e_stats['drafted']} drafts accepted "
        f"(rate exactly 1.0), tokens identical to plain decode")
    del echo, eng

    static_launches = static_path(torch, art, prompts[:8], "full width")
    sampled_twice(torch, art, prompts[:8])
    # the same check where bf16 rounding is not yet amplified to the
    # logits' size: smollm-135m's widths at 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model2 = Model(cfg2)
    art2 = api.compress(model2, init_params(model2.param_descs(), torch.Generator(
        device="cuda").manual_seed(0), device="cuda"), tiers=art.tiers, device="cuda")
    static_path(torch, art2, prompts[:8], "2 layers")
    return {k: launches.get(k, 0) + static_launches.get(k, 0)
            for k in set(launches) | set(static_launches)}


def profile_spec_round(torch, eng, prompts, sc):
    """Device time by kernel over one speculative round (k draft ticks and
    one verify) at 8 speculating slots, after an admission step."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset_stream()
    for p in prompts:
        eng.submit(p, max_new=3 * (sc.k + 1) + 2, quality="hi", speculate=sc)
    eng.step()  # admissions and the first round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        info = eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run_until_drained()
    kern = device_kernels(prof)
    busy = sum(t for _, t, _ in kern)
    say(f"  profile of one speculative round (8 slots, k={sc.k}, {info.drafted} drafted, "
        f"{info.accepted} accepted): wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall), "
        f"{sum(n for _, _, n in kern)} launches")
    by = {}
    for key, t, n in kern:
        name = kernel_of(key)
        if name:
            by[name] = (by.get(name, (0.0, 0))[0] + t, by.get(name, (0.0, 0))[1] + n)
    for name, (t, n) in sorted(by.items()):
        say(f"    {name:18s} {t / 1e3:7.3f} ms = {100 * t / max(busy, 1e-9):5.1f}% of device "
            f"time, {n:5d} launches ({t / max(n, 1):.1f} us each)")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:6]:
        say(f"    {t / 1e3:7.3f} ms  {n:5d} launches  {name[:90]}")


def _replay_logits(torch, model, params, prompts, toks, static: bool):
    """Each step's logits (8, V) of the static (one batch-8 prefill) or the
    continuous (single-slot admissions into a batch-8 cache) path, fed the
    path's own tokens: the same operations and shapes as the engine's."""
    from repro_torch.models.base import init_params

    b, maxp = len(prompts), max(len(p) for p in prompts)
    cache_len = maxp + MAX_NEW + 1
    pad = torch.zeros((b, maxp), dtype=torch.int32)
    for i, p in enumerate(prompts):
        pad[i, maxp - len(p):] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    if static:
        cache = init_params(model.cache_descs(b, cache_len), device="cuda")
        cache, first = model.prefill(params, cache, pad.to("cuda"), lens.to("cuda"))
        extra = {}
    else:
        cache = init_params(model.cache_descs(b, cache_len), device="cuda")
        zero = init_params(model.cache_descs(1, cache_len), device="cuda")
        tiers = torch.zeros((1,), dtype=torch.int32, device="cuda")
        rows = []
        for i in range(b):
            one, lg = model.prefill(params, zero, pad[i:i + 1].to("cuda"),
                                    lens[i:i + 1].to("cuda"), tiers, 0)
            cache = model.cache_insert_slot(cache, one, i)
            rows.append(lg[0])
        first = torch.stack(rows)
        extra = {"active": torch.ones((b,), dtype=torch.int32, device="cuda"),
                 "tiers": torch.zeros((b,), dtype=torch.int32, device="cuda"), "demand": 0}
    out = [first]
    t = torch.tensor(toks, dtype=torch.int32, device="cuda")  # (b, MAX_NEW)
    for step in range(MAX_NEW - 1):
        lg, cache = model.decode(params, cache, {"tokens": t[:, step:step + 1], **extra})
        out.append(lg[:, -1])
    return torch.stack(out, 1).float()  # (b, MAX_NEW, V)


def static_path(torch, art, prompts, label: str) -> dict:
    """Greedy ``generate(continuous=False)`` on a single-tier engine against
    the continuous path.

    A prompt whose tokens leave the continuous ones must do so at a tie:
    the continuous path's top-2 logit gap there at most twice its bf16
    error, the largest |logit - f32 logit| of the same weights, history and
    shapes evaluated in f32 arithmetic.  (At random weights the model
    amplifies rounding from layer to layer, so at 30 layers that error is
    of the logits' own size and only a bit-identical order keeps tokens.)"""
    from repro_torch.kernels import qsq, ref
    from repro_torch.models.api import Model

    st = art.engine(quality="mid", continuous=False, batch_slots=8, device="cuda")
    st.generate(prompts, max_new=MAX_NEW)  # warm the allocator
    qsq.reset_launches()
    ref.calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static = st.generate(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(qsq.launches)
    if not launches.get("qsq_matvec") or not launches.get("qsq_matmul"):
        raise AssertionError(f"the static path did not launch K1 and K3: {launches}")
    if sum(ref.calls.values()):
        raise AssertionError(f"plain versions ran on the static path: {dict(ref.calls)}")
    maxp = max(len(p) for p in prompts)
    say(f"  {label}: static greedy generate, {len(prompts)} prompts x {MAX_NEW} tokens in "
        f"{wall:.3f} s "
        f"({wall / MAX_NEW * 1e3:.2f} ms per decode position, prefill M={len(prompts) * maxp}); "
        f"kernels launched: {launches}; plain versions called: 0")
    cont = art.engine(quality="mid", batch_slots=8, per_request=False, device="cuda")
    continuous = cont.generate(prompts, max_new=MAX_NEW)
    ls = _replay_logits(torch, st.model, st.params, prompts, static, True)
    lc = _replay_logits(torch, cont.model, cont.params, prompts, continuous, False)
    for lg, toks, which in ((ls, static, "static"), (lc, continuous, "continuous")):
        if lg.argmax(-1).cpu().tolist() != toks:
            raise AssertionError(f"the {which} replay does not reproduce the {which} tokens")
    m32 = Model(dataclasses.replace(cont.model.cfg, dtype=torch.float32))
    err = (lc - _replay_logits(torch, m32, cont.params, prompts, continuous, False)).abs()
    err = err.amax(-1)  # (prompts, MAX_NEW): the continuous path's bf16 error
    say(f"    continuous path's bf16 error against f32 arithmetic: median "
        f"{float(err.median()):.3e}, max {float(err.max()):.3e} (max |logit| "
        f"{float(lc.abs().max()):.3e})")
    n_div = 0
    for i, (a, b) in enumerate(zip(static, continuous, strict=True)):
        if a == b:
            continue
        n_div += 1
        t = next(j for j in range(MAX_NEW) if a[j] != b[j])
        top = torch.topk(lc[i, t], 2).values
        gap = float(top[0] - top[1])
        bound = 2 * float(err[i, t])
        delta = float((ls[i, t] - lc[i, t]).abs().max())
        say(f"    prompt {i}: static leaves the continuous tokens at position {t}: top-2 gap "
            f"{gap:.3e} (bound {bound:.3e}), paths' logits differ by up to {delta:.3e}")
        if gap > bound:
            raise AssertionError(f"prompt {i} diverges at position {t} with a top-2 gap "
                                 f"{gap:.3e} above the bf16 bound {bound:.3e}: not a tie")
    say(f"  {label}: static vs continuous greedy: {len(prompts) - n_div} of {len(prompts)} token "
        f"lists identical; {n_div} diverge, each at a tie within the bf16 bound")
    return launches


def sampled_twice(torch, art, prompts) -> None:
    """Two sampled runs (temperature 0.8) from one seed give one token list."""
    hot = art.engine(quality="mid", temperature=0.8, batch_slots=8, device="cuda")
    a = hot.generate(prompts, max_new=MAX_NEW, seed=7)
    b = hot.generate(prompts, max_new=MAX_NEW, seed=7)
    if a != b or not all(len(x) == MAX_NEW for x in a):
        raise AssertionError("two sampled runs from one seed differ")
    greedy = art.engine(quality="mid", continuous=False, batch_slots=8,
                        device="cuda").generate(prompts, max_new=MAX_NEW)
    say(f"  sampling (temperature 0.8, seed 7): two runs identical, "
        f"{sum(x != y for x, y in zip(a, greedy, strict=True))} of {len(a)} lists differ "
        f"from greedy")


def spec_card_vs_cpu(torch, workdir: Path, card="cuda"):
    """d64 f32: speculative and static tokens identical on the card and the
    CPU (and speculative == plain on each), verify logits within 1e-4."""
    from repro_torch import api
    from repro_torch.models.base import init_params

    model, params = d64_model_params(torch)
    path = api.compress(model, params, device="cpu").save(workdir / "d64_spec.edge.npz")
    art = api.load(path)
    prompts = [[5, 9, 2], [17], [3, 3, 3, 3, 8, 1], [250, 1], [7] * 8, [1, 2, 3, 4]]
    quals = ["hi", "mid", "hi", "mid", "hi", "hi"]
    toks, logits = {}, {}
    for dev in ("cpu", card):
        eng = art.engine(quality="hi", batch_slots=4, max_prompt=8, max_len=32, device=dev)
        runs = []
        for speculate in (api.SpecConfig("lo", k=3), None):
            eng.reset_stream()
            rids = [eng.submit(p, max_new=8, quality=q, speculate=speculate if i % 2 == 0
                               else None) for i, (p, q) in enumerate(zip(prompts, quals))]
            eng.run_until_drained()
            runs.append([eng.poll(r).tokens for r in rids])
        if runs[0] != runs[1]:
            raise AssertionError(f"{dev}: speculative tokens differ from plain decode")
        if eng.stream_stats()["drafted"] != 0:
            raise AssertionError("the plain run drafted")
        static = art.engine(quality="mid", continuous=False, batch_slots=4,
                            device=dev).generate(prompts[:4], max_new=8)
        toks[dev] = (runs[0], static)
        tp, _ = art.serve_params("hi", per_request=True, device=dev)
        tiers = torch.tensor([0, 2, 1], dtype=torch.int32, device=dev)
        t = torch.tensor([[0, 0, 5, 9, 2, 8], [1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 7, 7]],
                         dtype=torch.int32, device=dev)
        lens = torch.tensor([4, 6, 2], dtype=torch.int32, device=dev)
        cache = init_params(model.cache_descs(3, 16), device=dev)
        cache, _ = model.prefill(tp, cache, t, lens, tiers, 0)
        window = torch.tensor([[3, 4, 5, 6], [9, 9, 0, 0], [1, 2, 3, 0]], dtype=torch.int32,
                              device=dev)
        batch = {"tokens": window, "start": torch.full((3,), 6, dtype=torch.int32, device=dev),
                 "wlen": torch.tensor([4, 2, 3], dtype=torch.int32, device=dev),
                 "spec": torch.ones((3,), dtype=torch.int32, device=dev), "tiers": tiers,
                 "demand": 0}
        lg, _ = model.verify(tp, cache, batch)
        logits[dev] = lg.cpu()
    if toks["cpu"] != toks[card]:
        raise AssertionError(f"speculative/static tokens differ between card and CPU:\n{toks}")
    diff = (logits[card] - logits["cpu"]).abs()
    if not bool((diff <= 1e-4 + 1e-4 * logits["cpu"].abs()).all()):
        raise AssertionError(f"card verify logits off the CPU's by {float(diff.max()):.3e}")
    path.unlink()
    say(f"  speculative ({sum(map(len, toks[card][0]))}) and static "
        f"({sum(map(len, toks[card][1]))}) tokens identical on card and CPU, speculative == "
        f"plain on both; verify logits max |diff| {float(diff.max()):.3e} (1e-4 abs + rel)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace (phase 6's resume check)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    say(f"    kernels built from {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s -> {build.library_path().relative_to(ROOT)}")
    (build.BUILD_DIR / "build.log").write_text(build.build_log)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"    ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    say("[2] kernels against their plain versions")
    n = check_kernels(torch, gen)
    say(f"    {n} checks passed: f32 bound, masked == truncated and demand-routed == "
        f"masked bit for bit")
    flush = Flush(torch)
    rows = time_kernels(torch, gen, flush)
    del flush

    workdir = ROOT / "build" / "smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    say("[3] full-width smollm-135m from a compressed, saved and reloaded EdgeArtifact")
    from repro_torch.configs import get_arch

    launches, art_path = serve_full_width(torch, workdir, get_arch("smollm_135m"))
    say("[4] card against CPU at the 2-layer d64 test config")
    card_vs_cpu(torch, workdir)
    (workdir / "d64.edge.npz").unlink()

    say("[5] the encoder K5 against its plain version")
    n5, k5_err = check_quantize(torch, gen)
    say(f"    {n5} checks passed: codes and scales bit for bit, pack_weight -> qsq_matmul "
        f"within the f32 bound")
    flush = Flush(torch)
    k5_row = time_quantize(torch, gen, flush)
    del flush
    say(f"    K5 summed over the 11 shapes: kernel {k5_row['ms']:.3f} ms, plain "
        f"{k5_row['plain_ms']:.3f} ms, bound {k5_row['bound_ms']:.3f} ms")
    say("[6] full-width smollm-135m training with QSQ gradient compression")
    train_launches = train_full_width(torch, workdir, get_arch("smollm_135m"))
    say("[7] training on the card against the CPU at the 2-layer d64 test config")
    train_card_vs_cpu(torch)
    say("[8] full-width smollm-135m speculative and static serving")
    spec_launches = speculative_and_static(torch, gen, art_path, get_arch("smollm_135m"))
    art_path.unlink()
    say("[8] card against CPU: speculative and static serving at the d64 test config")
    spec_card_vs_cpu(torch, workdir)

    for name, row in rows.items():
        row["launches"] = launches.get(name, 0)
        row["launches_spec_static"] = spec_launches.get(name, 0)
        row["max_abs_err"] = None
    errs = max_abs_errors(torch, gen)
    for name, e in errs.items():
        rows[name]["max_abs_err"] = e
    k5_row.update(launches=train_launches.get(K5[0], 0), max_abs_err=k5_err)
    say(f"    total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [rows[k] for k in KERNELS] + [k5_row]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def max_abs_errors(torch, gen) -> dict:
    """Max |kernel - plain| per kernel over the five shapes (bf16 x)."""
    from repro_torch.kernels import qsq, ref

    out = {}
    for name, (masked, m, _, _) in KERNELS.items():
        worst = 0.0
        for k, n in SHAPES:
            x, planes, scales, mask = operands(torch, m, k, n, gen, torch.bfloat16)
            kw = dict(group_size=GROUP, sign_mag=True, plane_major=True)
            fn = getattr(qsq, name)
            got = fn(x, mask, planes, scales, **kw) if masked else fn(x, planes, scales, **kw)
            want = (ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw) if masked
                    else ref.qsq_matmul_ref(x, planes, scales, GROUP, sign_mag=True,
                                            plane_major=True))
            worst = max(worst, float((got - want).abs().max()))
        out[name] = worst
    return out


if __name__ == "__main__":
    raise SystemExit(main())
