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
   kernels also at demand_drop = 2 against that case's own bound; then
   K1-K4 again on the Table II layout (interleaved planes, offset codes:
   ``pack_params``' form and the JAX kernels' default) at demand 0; then
   K1 (M = 8) to K4 (M = 64) at the 14 packed shapes of phi4-mini-3.8b,
   qwen3-14b and deepseek-7b (K to 17408, N to 200064): f32 bound, masked
   == truncated, no bf16 launch on the FMA route, each shape's plan and
   time against ``torch.matmul`` and the byte bound; the same at the three
   packed shapes of qwen3-moe-30b-a3b (2048x4096, 2048x512, 2048x151936)
   and of mixtral-8x22b (6144x6144, 6144x1024, 6144x32768), and at
   mamba2-1.3b's head (2048x50280, a ragged N), with K1 at M 8 and 2 and K3
   at M 640 there (the rows of phase 14) within the f32 bound;
3. the main path at full width: ``api.compress`` of smollm-135m (random
   weights from a seeded ``torch.Generator``), ``save``,
   ``api.load(verify=True)``, ``artifact.engine(quality="mid",
   batch_slots=8)`` serving 12 mixed-tier requests with staggered
   arrivals, once on an eager engine and once on a captured one (the
   serving steps as CUDA graphs): tokens, launch counts (replays counted)
   and dispatch counters identical; every kernel must launch, no plain
   version may run, the meter equals the traffic; a third captured run
   inside ``no_recapture`` with one host sync a step; decode, admission
   and verify logits of a replay equal eager bit for bit; then profiles
   of 4 decode steps and of one admission, eager and captured;
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
   engine's meter, captured and eager alike; one speculative round
   profiled, eager and captured, with one host sync a tick; the echo ladder
   (a draft tier that drops nothing) accepts every draft; greedy
   ``generate(continuous=False)`` on a single-tier engine launches K1 and
   K3, and where it leaves the continuous path's tokens (at 30 layers and
   at 2) the continuous top-2 logit gap is at most twice that path's bf16
   error against f32 arithmetic there (a tie); two sampled runs
   (temperature 0.8) from one seed agree; at 16 and 40 slots (verify
   windows of 80 and 200 rows, run in row blocks of at most 64) verify rows
   equal decode rows, speculative tokens equal plain decode, every round
   drafts min(k, max_new - emitted - 1) as the JAX engine does, and the
   re-read plane bytes are printed; and at the d64 f32 config the card's
   speculative and static tokens equal the CPU's, verify logits within
   1e-4;
9. the paper's pipeline: LeNet (300 steps, 1024 images) and ConvNet4 (150
   steps, 768) trained on the card on the synthetic images, with
   deterministic algorithms on so the numbers repeat from run to run; float
   accuracy, QSQ at phi = 1/2/4 (accuracy, Eq. 11/12 memory savings,
   zeros), the FC fine-tune after phi = 1, CSD at k = 1/2/3, and
   ``compress(None)`` -> save -> load -> ``dense_params`` at every tier;
   the card's quantization of the trained params equals the CPU's (bits
   reports exactly, scales within rtol 1e-6, codes except at ties);
10. full-width smollm-135m (random init, seed 0) packed by ``pack_params``
   and served by ``Model.prefill`` (K3) and ``Model.decode`` (K1) on Table
   II planes, twice with the same tokens and no plain version; the d64
   config gives the CPU's tokens and logits within 1e-4;
11. phi4-mini-3.8b at its published widths and depth (random init, seed
   0) through phase 3's path, eager and captured (identical tokens, the
   same checks), a speculative stream equal to plain decode, decode
   profiles; qwen3-14b and deepseek-7b at their published widths cut to 2
   layers (a reduction of depth only) serving mixed-tier greedy tokens
   through the captured engine, the long-K ``wd`` on the GEMM's 16-row
   tiles; the three smoke configs give the CPU's tokens on the card;
12. qwen3-moe-30b-a3b at its published widths cut to 8 layers (a reduction
   of depth only; random init, seed 0) through phase 3's path, eager and
   captured (identical tokens, the same checks, replayed logits equal
   eager), a speculative stream (drafted and accepted counts, and whether
   its tokens equal plain decode: under capacity routing they need not,
   so this is printed, not checked), the peak device memory, and the
   device time split of a decode step (K1/K2, the expert products,
   routing, attention, the rest); the MoE smoke config gives the CPU's
   tokens on the card;
13. mixtral-8x22b at its published widths cut to 2 layers (a reduction of
   depth only; random init, seed 0), the sliding-window ring (window 4096):
   compress, save, load(verify), a mixed-tier stream of 12 prompts of
   3900-4064 tokens on 8 slots (prefill width 4064, 64 new tokens, so every
   lane's decode wraps the 4096-entry ring) eager and captured with phase
   3's checks, replayed decode and admission logits equal eager;
   speculation refused; the decode step's device time split; the peak
   device memory; the ring's attention against windowed attention, one
   layer at a time on the same inputs (12 lanes, three evicting), within
   1e-5 in f64 and f32, two planted ring faults caught; 6 requests through
   the ring (a 4064-wide admission, 63 decodes) against the windowed
   full-sequence forward, both dropless and routed alike: logits within
   1e-6 of the largest in f64, the f32 gaps printed beside the f32
   forward's own distance from f64; the smoke config's ring (window 32)
   gives the CPU's tokens on the card
   in a session whose prefill is wider than the ring and one whose decode
   wraps it;
14. the recurrent families: mamba2-1.3b at its published widths and depth
   (48 layers, d 2048, vocab 50280; random init, seed 0; bf16) compressed,
   saved, loaded (verify) and served by single-tier engines at hi / mid /
   lo through ``generate()``'s static path (8 prompts of 48-64 tokens, a
   per-token scanned prefill, 32 new tokens): one host sync a generate, the
   same tokens on a second identical call, K1 (the head) once a position
   and no other kernel, no plain version, the nonzero plane words served
   ordered hi > mid > lo; prefill and decode ms a position, tokens/s, the
   bytes a step moves in W's dense decode and in K1 beside the meter's
   packed figure, peak device memory; a profiled decode step split
   into W's dense decode of the mixers' weights, the convs and SSD
   recurrence, the mixers' matmuls and gated norms, K1 on the head and the
   rest; then at 4 layers in f32, ``Model.forward`` on 2 x 320 tokens (the
   head through K3) against 320 ``Model.decode`` steps, within 2e-4 of the
   largest |logit|, a planted chunk-boundary fault caught; the mamba2 and
   jamba smoke configs give the CPU's static tokens at every tier on the
   card, last prefill logits within 1e-4;
15. the cross-attending families, with their cross gates (zero at init,
   which makes a cross block the identity) drawn from a seed:
   llama-3.2-vision-11b at its published widths cut to 10 layers (two
   groups of five self layers, each closed by a gated cross block; a
   reduction of depth only) and whisper-tiny at its published config
   (random init, seed 0; bf16), compressed, saved, loaded (verify) and
   served by single-tier engines at hi / mid / lo through ``generate()``'s
   static path over zero cross K/V, as the engine builds its cache (8
   prompts of 32-64 tokens and 16 new ones; of 4-16 and 64): one host sync
   a generate, the same tokens on a second call, K1 69 (17) times a
   position and no other kernel, no plain version, nonzero plane words hi >
   mid > lo; ms a position, tokens/s, peak memory, K1's bytes a position
   beside the meter's; the filled path (``vision_prefill_cross_kv`` on 8 x
   1024 seeded embeddings, ``encdec_prefill_cross`` on 8 x 1500 frames:
   K3), then prefill and decode, whose tokens must differ from the zero-K/V
   run's (a sanity check); a profiled decode step split into K1,
   self-attention, cross attention, the cross gates and MLP (whisper: its
   GELU MLP and W's dense decode of it) and the rest; in f32, the VLM cut to
   5 layers and whisper, ``Model.forward`` against step-by-step decode over
   the filled cache within 1e-4 of the largest |logit|, the first cross
   block's K/V zeroed caught above 1e-2; both smoke configs give the CPU's
   tokens on the card, on the zero-K/V path at every tier and on the
   filled path, last prefill logits within 1e-4.  Phase 2 also holds K1-K4
   at the two families' packed shapes (whisper's head N = 51865 is odd)
   and K3 at the rows that fill cross K/V (M 8192 and 12000);
16. the dry run (``repro_torch.launch.dryrun``) held against the card:
   smollm-135m's decode_32k (128 slots, a 32768-entry cache) at 1 and 2
   layers, dense and packed (K3 at M = 128), and an 8 x 1024 train step at
   1 layer with gradient compression (K5), each dry-run on meta tensors on
   the one-card mesh and then run on the card from the same descriptors
   made real by ``init_params`` (seed 0): the card's FlopCounterMode total
   plus the kernels' 2 M K N equals the meta count, the dispatch counters,
   plane traffic and argument bytes are equal, the peak above the bytes
   held before the arguments is within 10% of the traced ``peak_bytes``,
   K3 / K5 launch and no plain version runs; then smollm-135m at its 30
   layers dry-run at the four shapes on the host (peak GB a device against
   80 GB, the dominant roofline term, ``useful_flops_ratio``);
17. the port's qsqlint (``repro_torch.analysis``): the port's files lint
   clean (files linted, pragmas honoured by rule, seconds); a captured d64
   engine serves four mixed-tier requests, one speculating, so decode,
   admission and verify are captured, and the functions of
   ``serve/engine.py`` and ``train/step.py`` entered inside the
   ``torch.cuda.graph`` block (``sys.setprofile``) include the three run
   closures and are all among the linter's capture contexts; a planted
   ``.item()`` in a ``StepGraphs.run`` step is flagged by QSQ002 at its
   line and, run in a child process on the card, fails its capture.

Any failed check raises, so the script exits non-zero and prints no
result.  The second-to-last line is the per-kernel JSON summary and the
last line ``{"ok": true, "device": {...}}``.  The compiler's register and
shared-memory report goes to ``build/kernels/build.log``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
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


def operands(torch, m, k, n, gen, x_dtype, min_drop=0, plane_major=True, group=GROUP):
    from repro_torch.kernels.ref import MASK_VARIANTS

    dev = gen.device
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    planes = torch.randint(-2**31, 2**31 - 1, (3, k // 32, n) if plane_major else
                           (k // 32, 3, n), generator=gen, device=dev, dtype=torch.int32)
    scales = torch.rand((k // group, n), generator=gen, device=dev) * 0.09 + 0.01
    variants = torch.tensor(MASK_VARIANTS[min_drop:], dtype=torch.int32, device=dev)
    pick = torch.randint(0, len(variants), (m,), generator=gen, device=dev)
    return x, planes, scales, variants[pick].contiguous()


def f32_bound(torch, x, plane_mask, planes, scales, demand, sign_mag=True, plane_major=True,
              group=GROUP):
    """2*K*2^-24*(|x| @ |w|) per output, each row with its own mask's weight."""
    from repro_torch.kernels import ref

    k = x.shape[1]
    xs = ref.variant_split(x.float().abs(), plane_mask, demand)
    out = 0
    for i, mask in enumerate(ref.MASK_VARIANTS[demand:]):
        w = ref.qsq_dequant_ref(planes, scales, group, sign_mag=sign_mag,
                                plane_major=plane_major, n_planes=3 - demand,
                                code_mask=mask).to(x.dtype).float()
        out = out + xs[i].double() @ w.abs().double()
    return 2 * k * 2.0**-24 * out


def check_kernels(torch, gen, cases=None, sign_mag=True, plane_major=True, group=GROUP,
                  errs=None, shapes=SHAPES, demands=(0, 1, 2)):
    """Correctness at every shape, dtype and demand; raises on any miss.
    ``cases`` is a list of (kernel name, M); by default each kernel at its
    phase-2 M.  The interleaved layout (``plane_major=False``) is held at
    demand 0 only: the unmasked kernels refuse a demand floor there.
    ``errs``, if given, collects each kernel's worst |kernel - plain|."""
    from repro_torch.kernels import qsq, ref

    if cases is None:
        cases = [(name, m) for name, (_, m, _, _) in KERNELS.items()]
    layout = dict(sign_mag=sign_mag, plane_major=plane_major)
    n_checks = 0
    for k, n in shapes:
        for x_dtype in (torch.bfloat16, torch.float32):
            for demand in demands if plane_major else (0,):
                for name, m in cases:
                    masked = KERNELS[name][0]
                    x, planes, scales, mask = operands(torch, m, k, n, gen, x_dtype, demand,
                                                       plane_major, group)
                    kw = dict(group_size=group, demand_drop=demand, **layout)
                    fn = getattr(qsq, name)
                    if not masked:
                        mask = torch.full((m,), ref.MASK_VARIANTS[demand], dtype=torch.int32,
                                          device=x.device)
                    got = fn(x, mask, planes, scales, **kw) if masked else fn(
                        x, planes, scales, **kw)
                    torch.cuda.synchronize()
                    want = ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw)
                    err = (got.double() - want.double()).abs()
                    bound = f32_bound(torch, x, mask, planes, scales, demand, group=group,
                                      **layout)
                    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
                        raise AssertionError(
                            f"{name} K={k} N={n} {x_dtype} demand={demand}: max err "
                            f"{float(err.max()):.3e} exceeds the f32 bound")
                    n_checks += 1
                    if errs is not None:
                        errs[name] = max(errs.get(name, 0.0), float(err.max()))
                    if masked:
                        # bit-identity: each row equals the unmasked kernel on
                        # planes truncated to the row's drop ...
                        plain_fn = getattr(qsq, name.replace("_masked", ""))
                        for drop, code_mask in enumerate(ref.MASK_VARIANTS):
                            rows = mask == code_mask
                            if drop < demand or not bool(rows.any()):
                                continue
                            trunc = planes.clone()
                            if plane_major:  # MSB first
                                trunc[3 - drop:] = 0
                            else:  # LSB first
                                trunc[:, :drop] = 0
                            base = plain_fn(x, trunc, scales, group_size=group, **layout)
                            if not torch.equal(got[rows], base[rows]):
                                raise AssertionError(f"{name} K={k} N={n} {x_dtype}: masked "
                                                     f"rows at drop {drop} differ from the "
                                                     f"unmasked kernel on truncated planes")
                        # ... and demand routing changes no bit
                        full = fn(x, mask, planes, scales, group_size=group, demand_drop=0,
                                  **layout)
                        if demand and not torch.equal(got, full):
                            raise AssertionError(f"{name} K={k} N={n} {x_dtype}: demand "
                                                 f"{demand} routing changed the output")
                        n_checks += 2
    torch.cuda.synchronize()
    return n_checks


def time_kernels(torch, gen, flush, sign_mag=True, plane_major=True):
    """Per kernel, summed over the five smollm shapes (bf16 x, all planes):
    kernel, plain-version and library times and the bound; on the
    plane-major layout the masked kernels also at demand_drop = 2 (one
    plane read, one variant decoded)."""
    rows = {}
    layout = dict(sign_mag=sign_mag, plane_major=plane_major)
    for name, (masked, m, source, replaces) in KERNELS.items():
        for demand in (0, 2) if masked and plane_major else (0,):
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_s=0.0, ops_s=0.0,
                       bound=0.0)
            for k, n in SHAPES:
                b_s, o_s, ms, plain_ms, lib_ms = time_one(torch, gen, flush, name, masked, m,
                                                          k, n, demand, **layout)
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


def time_one(torch, gen, flush, name, masked, m, k, n, demand, sign_mag=True,
             plane_major=True, plain_too=True, runs=25):
    """One shape: (bytes bound s, ops bound s, kernel ms, plain ms, torch.matmul ms).
    The bound counts the 3 - demand planes the call must read.  Without
    ``plain_too`` the plain version is not timed (its ms comes back None)."""
    from repro_torch.kernels import qsq, ref

    layout = dict(sign_mag=sign_mag, plane_major=plane_major)
    x, planes, scales, mask = operands(torch, m, k, n, gen, torch.bfloat16, demand, plane_major)
    kw = dict(group_size=GROUP, demand_drop=demand, **layout)
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
            return ref.qsq_matmul_ref(x, planes, scales, GROUP, **layout)
    w = ref.qsq_dequant_ref(planes, scales, GROUP, n_planes=3 - demand,
                            **layout).to(torch.bfloat16)

    def library():
        return torch.matmul(x, w)

    ms = time_ms(torch, kern, flush, runs)
    plain_ms = time_ms(torch, plain, flush, runs) if plain_too else None
    lib_ms = time_ms(torch, library, flush, runs)
    nbytes = (m * k * 2 + (3 - demand) * (k // 32) * n * 4 + (k // GROUP) * n * 4 + m * n * 4
              + (m * 4 if masked else 0))
    ops = 2 * m * k * n
    return nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"], ms, plain_ms, lib_ms


# (K, N) of the packed leaves of the other dense configs: wq, wk/wv (deepseek's
# equal wq), wg/wu, wd, head
DENSE_SHAPES = {
    "phi4-mini-3.8b": [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 200064)],
    "qwen3-14b": [(5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120), (5120, 151936)],
    "deepseek-7b": [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 102400)],
}


# (K, N) of qwen3-moe-30b-a3b's packed leaves: wq, wk/wv, head (the experts
# serve dense: their expert axis is not a stack axis)
MOE_SHAPES = {"qwen3-moe-30b-a3b": [(2048, 4096), (2048, 512), (2048, 151936)]}
# (K, N) of mixtral-8x22b's packed leaves: wq, wk/wv, head
MIXTRAL_SHAPES = {"mixtral-8x22b": [(6144, 6144), (6144, 1024), (6144, 32768)]}
# (K, N) of mamba2-1.3b's kernel-served leaf: the head (the mixers' packed
# leaves decode to dense through W); N is not a multiple of 16
MAMBA2_SHAPES = {"mamba2-1.3b": [(2048, 50280)]}
# (kernel, M) of the head on [14]'s path: K1 at the 8 serving slots (bf16),
# K1 at the forward-vs-decode check's 2 rows and K3 on its 2 x 320 tokens (f32)
MAMBA2_CASES = [("qsq_matvec", 8), ("qsq_matvec", 2), ("qsq_matmul", 640)]


def dense_shapes(torch, gen, flush, by_arch=None) -> dict:
    """K1-K4 at the packed shapes of ``by_arch`` (default: the 14 of
    phi4-mini, qwen3-14b and deepseek-7b): within the f32 bound of their
    plain versions (bf16 and f32 x, all planes, a random mix of tier
    masks), masked rows equal to the unmasked kernel on truncated planes;
    no bf16 launch on the FMA route; then each shape's plan and its cold-L2
    time (bf16 x) against ``torch.matmul`` and the byte bound.  Returns
    each kernel's sums over the shapes."""
    from repro_torch.kernels import qsq

    by_arch = DENSE_SHAPES if by_arch is None else by_arch
    shapes = [sh for v in by_arch.values() for sh in v]
    qsq.reset_launches()
    n = check_kernels(torch, gen, shapes=shapes, demands=(0,))
    fma = {k: v for k, v in qsq.launches.items() if k.endswith(":fma")}
    if fma:
        raise AssertionError(f"bf16 launches took the FMA route: {fma}")
    say(f"  {n} checks at the {len(shapes)} shapes passed: f32 bound, masked == truncated bit "
        f"for bit; bf16 launches on the FMA route: 0")
    sums = {}
    for name, (masked, m, _, _) in KERNELS.items():
        tot = dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
        for arch, shs in by_arch.items():
            for k, nn in shs:
                p = qsq.launch_plan("gemv" if m <= 16 else "gemm", m, k, nn, GROUP,
                                    torch.bfloat16)
                b_s, o_s, ms, _, lib_ms = time_one(torch, gen, flush, name, masked, m, k, nn, 0,
                                                   plain_too=False, runs=10)
                bound = max(b_s, o_s) * 1e3
                tot["ms"] += ms
                tot["library_ms"] += lib_ms
                tot["bound_ms"] += bound
                say(f"  {name:18s} {arch:17s} K={k:5d} N={nn:6d} M={m:2d}: kernel "
                    f"{ms * 1e3:8.2f} us  torch.matmul {lib_ms * 1e3:8.2f} us  bound "
                    f"{bound * 1e3:7.2f} us ({bound / ms:5.1%} of bound); plan mt={p.mt} "
                    f"nt={p.nt} wn={p.wn} wk={p.wk} cs={p.cs} persist={p.persist}, "
                    f"{p.blocks(m, nn)} blocks, {p.smem_bytes(k) / 1024:.1f} KB")
        sums[name] = tot
        say(f"  {name} summed over the {len(shapes)} shapes: kernel {tot['ms']:.4f} ms, "
            f"torch.matmul {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return sums


# --------------------------------------------------------------------------
# Phase 3: the full-width main path
# --------------------------------------------------------------------------
TIER_NAMES = ["hi", "mid", "lo"]


def serving_tiers(api):
    """hi / mid / lo; lo truncates three quarters of the packed leaves, so the
    most sensitive ones serve untiered through the unmasked kernels at every
    tier."""
    return api.QualitySpec((api.QualityTier("hi", 0, 0.0), api.QualityTier("mid", 1, 0.5),
                            api.QualityTier("lo", 2, 0.75)))


def compress_saved(torch, workdir: Path, cfg, name: str, device="cuda", prepare=None):
    """``api.compress`` of ``cfg`` (random weights from seed 0, then
    ``prepare(params)`` if given), ``save``, ``api.load(verify=True)`` ->
    (artifact, path, compress+save s, load s)."""
    from repro_torch import api
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    model = Model(cfg)
    params = init_params(model.param_descs(), torch.Generator(device=device).manual_seed(0),
                         device=device)
    if prepare is not None:
        prepare(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = api.compress(model, params, tiers=serving_tiers(api), device=device)
    del params
    path = art.save(workdir / f"{name}.edge.npz")
    t_save = time.perf_counter() - t0
    art = api.load(path, verify=True)
    if art.plane_damage:
        raise AssertionError(f"fresh artifact failed its checksums: {art.plane_damage}")
    return art, path, t_save, time.perf_counter() - t0 - t_save


def stream_prompts(torch, cfg, seed=1):
    """The 12 prompts of the mixed-tier stream, 5 to 64 tokens."""
    rng = torch.Generator().manual_seed(seed)
    lengths = [5 + (59 * i) // 11 for i in range(12)]  # 5 .. 64
    return [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist() for n in lengths]


def _wrap(eng, attr, wrapper):
    """Shadow the engine's method ``attr`` by ``wrapper(orig)`` on the instance."""
    setattr(eng, attr, wrapper(getattr(eng, attr)))


def _timed(torch, sink):
    def wrapper(orig):
        def call(*a):
            t0 = time.perf_counter()
            out = orig(*a)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return call
    return wrapper


def _sync_counted(torch, bad):
    """Count the host syncs of each plain ``step()`` (torch's sync debug
    mode): one for each admission and one for the decode."""
    import warnings

    def wrapper(orig):
        def step():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                info = orig()
            n = sum("synchroniz" in str(w.message) for w in caught)
            want = len(info.admitted) + (1 if info.live else 0)
            if n != want:
                bad.append((n, want))
            return info
        return step
    return wrapper


def serve_stream(torch, eng, prompts, cfg, timed=True, count_syncs=False,
                 max_new=16) -> dict:
    """The mixed-tier stream on ``eng`` (8 requests up front, 4 joining the
    running decode two steps apart, ``max_new`` tokens each, tiers
    hi/mid/lo in turn): every kernel of ``KERNELS`` launches, no plain
    version runs, no bf16 call takes the FMA route, and the per-call
    dispatch traffic equals the byte meter.  ``timed`` times each admission
    and decode call (synchronized); ``count_syncs`` instead checks one host
    sync per step."""
    from repro_torch.kernels import dispatch, qsq, ref

    eng.reset_stream()
    qsq.reset_launches()
    ref.calls.clear()
    dispatch.reset_counters()
    admit_ms, decode_ms, bad = [], [], []
    if timed:
        _wrap(eng, "_admit_call", _timed(torch, admit_ms))
        _wrap(eng, "_decode_call", _timed(torch, decode_ms))
    if count_syncs:
        _wrap(eng, "step", _sync_counted(torch, bad))
        torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    try:
        rids = [eng.submit(p, max_new=max_new, quality=TIER_NAMES[i % 3])
                for i, p in enumerate(prompts[:8])]
        for p_i in range(8, 12):  # later arrivals join the running decode
            eng.step()
            eng.step()
            rids.append(eng.submit(prompts[p_i], max_new=max_new,
                                   quality=TIER_NAMES[p_i % 3]))
        eng.run_until_drained()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for attr in ("_admit_call", "_decode_call", "step"):
            eng.__dict__.pop(attr, None)
    wall = time.perf_counter() - t1
    if bad:
        raise AssertionError(f"steps with other than one host sync per call: {bad[:6]}")
    launches = dict(qsq.launches)
    stats = eng.stream_stats()
    tokens = []
    for r in rids:
        st = eng.poll(r)
        if st.finish_reason is None or st.finish_reason.value != "done" or \
                len(st.tokens) != max_new:
            raise AssertionError(f"request {r} ended {st.finish_reason} with "
                                 f"{len(st.tokens)} tokens")
        if not all(0 <= t < cfg.vocab for t in st.tokens):
            raise AssertionError(f"request {r} emitted out-of-vocab tokens")
        tokens.append(st.tokens)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    fma = {k: v for k, v in launches.items() if k.endswith(":fma")}
    if fma:
        raise AssertionError(f"bf16 launches took the FMA route: {fma}")
    if sum(ref.calls.values()):
        raise AssertionError(f"plain versions ran on the main path: {dict(ref.calls)}")
    if 4 * dispatch.traffic["plane_words_read"] != stats["bytes_read"]:
        raise AssertionError("per-call dispatch traffic disagrees with the byte meter")
    return dict(tokens=tokens, launches=launches, counters=dict(dispatch.counters),
                traffic=dict(dispatch.traffic), stats=stats, wall=wall,
                decode_ms=statistics.median(decode_ms) if decode_ms else None,
                admit_ms=statistics.median(admit_ms) if admit_ms else None,
                n_decode=len(decode_ms), n_admit=len(admit_ms))


def eager_and_captured(torch, art, cfg, label: str, slots=8, prompts=None, max_new=16,
                       **eng_kw) -> tuple[dict, dict, object]:
    """The mixed-tier stream (``prompts``, default :func:`stream_prompts`) on
    an eager engine and on a captured one from the same artifact: the
    captured engine's first run captures, its second is timed, its third
    runs inside ``no_recapture`` with one host sync a step checked.  Tokens,
    launch counts and dispatch counters equal the eager run's.  ``eng_kw``
    goes to ``art.engine``.  Returns (eager run, captured run, captured
    engine)."""
    from repro_torch.analysis import no_recapture

    prompts = stream_prompts(torch, cfg) if prompts is None else prompts
    kw = dict(max_new=max_new)
    eager = art.engine(quality="mid", batch_slots=slots, device="cuda", eager=True, **eng_kw)
    e = serve_stream(torch, eager, prompts, cfg, **kw)
    del eager
    eng = art.engine(quality="mid", batch_slots=slots, device="cuda", **eng_kw)
    serve_stream(torch, eng, prompts, cfg, timed=False, **kw)
    c = serve_stream(torch, eng, prompts, cfg, **kw)
    with no_recapture(eng):
        again = serve_stream(torch, eng, prompts, cfg, timed=False, count_syncs=True, **kw)
    for run, which in ((c, "captured"), (again, "re-run")):
        if run["tokens"] != e["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(run["tokens"], e["tokens"], strict=True))
                   if a != b]
            raise AssertionError(f"{label}: {which} tokens differ from eager for requests {bad}")
        if (run["launches"], run["counters"], run["traffic"]) != \
                (e["launches"], e["counters"], e["traffic"]):
            raise AssertionError(f"{label}: {which} counts {run['launches']} != eager "
                                 f"{e['launches']}")
    keys = eng._session.graphs.keys()
    tokens = c["stats"]["tokens"]
    say(f"  {label}: 12 requests x {max_new} tokens on {slots} slots, eager and captured: tokens "
        f"identical, kernel launches identical (replays counted) {c['launches']}, dispatch "
        f"routes {c['counters']}; plain versions 0; bf16 launches on the FMA route 0")
    say(f"  {label}: {len(keys)} graphs {sorted(keys)}; a third run inside no_recapture "
        f"(admissions, evictions, lanes re-tiered) added none, one host sync a step")
    say(f"  {label}: decode step median eager {e['decode_ms']:.2f} ms, captured "
        f"{c['decode_ms']:.2f} ms ({e['decode_ms'] / c['decode_ms']:.1f}x) over "
        f"{c['n_decode']} steps; admission (prefill + insert) median eager "
        f"{e['admit_ms']:.2f} ms, captured {c['admit_ms']:.2f} ms over {c['n_admit']}")
    say(f"  {label}: tokens/s eager {tokens / e['wall']:.1f} ({e['wall']:.3f} s), captured "
        f"{tokens / c['wall']:.1f} ({c['wall']:.3f} s); bytes/token "
        f"{c['stats']['bytes_per_token']:.1f}, read_frac {c['stats']['read_frac']:.4f} "
        f"(= per-call dispatch traffic, eager and captured)")
    return e, c, eng


def graph_logits_equal(torch, eng, label: str) -> None:
    """One decode, one admission prefill and one verify of ``eng``'s model
    and params, each run eagerly on one copy of the live cache and as a
    captured graph on another: logits equal bit for bit (a cuBLAS choice
    that changed under capture would show here)."""
    from repro_torch.serve.graphs import StepGraphs

    s, model, params = eng._session, eng.model, eng.params
    b, dev = s.sched.n_slots, eng.device
    g = torch.Generator(device=dev).manual_seed(5)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=torch.int32)

    tiers = torch.arange(b, device=dev, dtype=torch.int32) % 3
    ones = torch.ones_like(tiers)
    start = torch.full((b,), 70, dtype=torch.int32, device=dev)
    cur, window = ints(model.cfg.vocab, (b, 1)), ints(model.cfg.vocab, (b, W_VERIFY))
    toks = ints(model.cfg.vocab, (1, s.prefill_len))
    lens = torch.full((1,), s.prefill_len, dtype=torch.int32, device=dev)
    wlen = torch.full_like(start, W_VERIFY)
    fns = {
        "decode": lambda c: model.decode(params, c, {
            "tokens": cur, "active": ones, "tiers": tiers, "demand": 0})[0],
        "admission prefill": lambda c: model.prefill(params, s.zero_slot_cache, toks, lens,
                                                     tiers[1:2], 1)[1],
    }
    if model.cfg.window is None:  # a ring cannot verify (it cannot roll back)
        fns["verify"] = lambda c: model.verify(params, c, {
            "tokens": window, "start": start, "wlen": wlen, "spec": ones, "tiers": tiers,
            "demand": 0})[0]
    for name, fn in fns.items():
        caches = [type(s.cache)(kv=type(s.cache.kv)(*(t.clone() for t in s.cache.kv)))
                  for _ in range(2)]
        want = fn(caches[0])
        got = StepGraphs(dev).run(name, lambda c=caches[1], f=fn: f(c),
                                  restore=(caches[1].kv.pos,))
        if not torch.equal(want, got):
            raise AssertionError(f"{label}: captured {name} logits differ from eager by "
                                 f"{float((want - got).abs().max()):.3e}")
    say(f"  {label}: {', '.join(fns)} logits of a captured replay equal the eager ones bit "
        f"for bit")


def serve_full_width(torch, workdir: Path, cfg):
    art, path, t_save, t_load = compress_saved(torch, workdir, cfg, "smollm_135m")
    say(f"  artifact: {path.stat().st_size / 2**20:.1f} MiB, compress+save {t_save:.1f} s, "
        f"load(verify) {t_load:.1f} s")
    e, c, eng = eager_and_captured(torch, art, cfg, "smollm-135m")
    graph_logits_equal(torch, eng, "smollm-135m")
    prompts = stream_prompts(torch, cfg)
    eager = art.engine(quality="mid", batch_slots=8, device="cuda", eager=True)
    for label, en in (("eager", eager), ("captured", eng)):
        profile_decode(torch, en, prompts[:8], TIER_NAMES, label=label)
        profile_admission(torch, en, prompts[11], "mid", label=label)
    return c["launches"], path


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


def profile_admission(torch, eng, prompt, quality, label=""):
    """Device time by kernel over one admission (a single-slot prefill at
    M = 64 and its cache insert), K4's share of it and the launches."""
    from torch.profiler import ProfilerActivity, profile

    orig = eng._admit_call
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

    eng.reset_stream()
    eng._admit_call = profiled
    try:
        eng.submit(prompt, max_new=2, quality=quality)
        eng.step()
    finally:
        del eng._admit_call
    eng.run_until_drained()
    kern = device_kernels(box["prof"])
    busy = sum(t for _, t, _ in kern)
    by = {}
    for key, t, n in kern:
        name = kernel_of(key)
        if name:
            by[name] = (by.get(name, (0.0, 0))[0] + t, by.get(name, (0.0, 0))[1] + n)
    k4_us, k4_n = by.get("qsq_matmul_masked", (0.0, 0))
    say(f"  {label} profile of one admission ({len(prompt)}-token prompt, M="
        f"{eng._ensure_session().prefill_len}): wall "
        f"{box['wall_us'] / 1e3:.2f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / box['wall_us']:.1f}% of wall), {sum(n for _, _, n in kern)} launches; "
        f"K4 {k4_us / 1e3:.3f} ms = {100 * k4_us / max(busy, 1e-9):.1f}% of device time in "
        f"{k4_n} launches")
    for name, (t, n) in sorted(by.items()):
        say(f"    {name:18s} {t / 1e3:7.3f} ms  {n:4d} launches  ({t / max(n, 1):.1f} us each)")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:6]:
        say(f"    {t / 1e3:7.3f} ms  {n:5d} launches  {name[:90]}")


def profile_decode(torch, eng, prompts, names, steps=4, label=""):
    """Device time by kernel over ``steps`` full-batch decode steps (after
    the launch counts were read), and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset_stream()
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
    say(f"  {label} profile of {steps} decode steps at 8 live slots: wall "
        f"{wall_us / steps / 1e3:.2f} "
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
def d64_model_params(torch, cfg=None):
    """The 2-layer d64 test config (f32), or ``cfg``, and its parameters on
    the CPU, drawn with numpy from seed 0."""
    import numpy as np

    from repro_torch.configs.base import ArchConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.api import Model
    from repro_torch.models.base import is_desc
    from repro_torch.tree import tree_map

    if cfg is None:
        cfg = ArchConfig(name="smollm-bench", family="dense", n_layers=2, d_model=64,
                         n_heads=4, n_kv=2, d_ff=128, vocab=256, dtype=torch.float32,
                         remat=False)
    model = Model(cfg)
    rng = np.random.default_rng(0)

    def draw(d):
        if d.init in ("ones", "zeros"):
            return (np.ones if d.init == "ones" else np.zeros)(d.shape, np.float32)
        std = {"fan_in": d.scale / np.sqrt(d.shape[-2]), "normal": d.scale * 0.02,
               "small": d.scale * 0.006}[d.init]
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return model, params_from_numpy(tree_map(draw, model.param_descs(), is_leaf=is_desc), "cpu")


def card_vs_cpu(torch, workdir: Path, card="cuda", cfg=None):
    """Greedy tokens identical on the card (captured engine) and the CPU,
    logits within 1e-4, at the d64 test config or ``cfg``."""
    import numpy as np

    from repro_torch import api
    from repro_torch.models.base import init_params

    model, params = d64_model_params(torch, cfg)
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
        if dev != "cpu" and len(eng._session.graphs) == 0:
            raise AssertionError("the card engine captured no graph")
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
    say(f"  {model.cfg.name}: {sum(len(t) for t in toks[card])} greedy tokens identical on "
        f"card (captured) and CPU; logits max |diff| {float(diff.max()):.3e} (tolerance 1e-4 "
        f"abs + 1e-4 rel)")
    path.unlink()


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


def _stream(torch, eng, prompts, quals, spec, speculate, first=8):
    """The requests, ``first`` up front and the rest joining the running
    decode two steps apart, as in phase 3; ``spec[i]`` requests speculate
    with ``speculate``."""
    eng.reset_stream()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW, quality=q, speculate=speculate if sp else None)
            for p, q, sp in zip(prompts[:first], quals, spec, strict=False)]
    for i in range(first, len(prompts)):
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
    _stream(torch, eng, prompts, quals, spec, None)  # captures the plain stream's keys
    plain_toks, plain_stats, plain_wall = _stream(torch, eng, prompts, quals, spec, None)

    ticks = []

    def counted(kind):
        """Record each draft tick's and each verify's launches (replays
        counted) and the verify's rows (M = 8 x window)."""
        def wrapper(fn):
            def wrapped(s, *a):
                before = dict(qsq.launches)
                draft = dispatch.traffic["phase:draft:plane_words_read"]
                out = fn(s, *a)
                if kind == "verify" or dispatch.traffic["phase:draft:plane_words_read"] > draft:
                    m = a[0].size if kind == "verify" else len(a[0])
                    ticks.append((kind, m, {k: v - before.get(k, 0)
                                            for k, v in qsq.launches.items()}))
                return out
            return wrapped
        return wrapper

    _stream(torch, eng, prompts, quals, spec, sc)  # the captures: one per key
    _wrap(eng, "_decode_call", counted("draft"))
    _wrap(eng, "_verify_call", counted("verify"))
    qsq.reset_launches()
    ref.calls.clear()
    dispatch.reset_counters()
    try:
        spec_toks, stats, spec_wall = _stream(torch, eng, prompts, quals, spec, sc)
    finally:
        del eng._decode_call, eng._verify_call
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
    eager = art.engine(quality="mid", batch_slots=8, device="cuda", eager=True)
    e_toks, e_stats, e_wall = _stream(torch, eager, prompts, quals, spec, sc)
    if e_toks != spec_toks or e_stats != stats:
        raise AssertionError("eager speculative stream differs from the captured one")
    say(f"  the same speculative stream eager: tokens and stream_stats identical to the "
        f"captured run; {len(eng._session.graphs)} graphs {sorted(eng._session.graphs.keys())}")
    say(f"  tokens/s captured: speculative {stats['tokens'] / spec_wall:.1f} ({spec_wall:.3f} "
        f"s), plain {plain_stats['tokens'] / plain_wall:.1f} ({plain_wall:.3f} s); eager "
        f"speculative {e_stats['tokens'] / e_wall:.1f} ({e_wall:.3f} s)")
    for label, en in (("eager", eager), ("captured", eng)):
        profile_spec_round(torch, en, prompts[:8], sc, label=label)
    del eager

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


def profile_spec_round(torch, eng, prompts, sc, label=""):
    """Device time by kernel over one speculative round (k draft ticks and
    one verify) at 8 speculating slots, after an admission step; then the
    round's host syncs (one a draft tick, one for the verify) and its wall
    time unprofiled."""
    import warnings

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
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            info2 = eng.step()
            plain_wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if info2.drafted != 8 * sc.k or syncs != sc.k + 1:
        raise AssertionError(f"{label} round: {info2.drafted} drafted, {syncs} host syncs "
                             f"(want {8 * sc.k} and {sc.k + 1})")
    eng.run_until_drained()
    kern = device_kernels(prof)
    busy = sum(t for _, t, _ in kern)
    say(f"  {label} round unprofiled: {plain_wall:.2f} ms wall, {syncs} host syncs "
        f"({sc.k} draft ticks + 1 verify)")
    say(f"  {label} profile of one speculative round (8 slots, k={sc.k}, {info.drafted} drafted, "
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


# --------------------------------------------------------------------------
# Phase 8, wide: verify windows beyond SAME_PLAN_ROWS, in row blocks
# --------------------------------------------------------------------------
WIDE_SLOTS = (16, 40)  # verify M = 80 (two row blocks) and 200 (four)


def check_block_rows(torch, gen, slots: int) -> int:
    """A verify window of ``slots`` x W rows, run through the dispatcher in
    row blocks of at most SAME_PLAN_ROWS as ``lm_verify`` runs it, equals the
    decode step's rows (the dispatcher at M = slots) bit for bit: five
    shapes, bf16 and f32 x, demand 0 and 2, masked and unmasked."""
    from repro_torch.kernels import dispatch, ref

    m = slots * W_VERIFY
    n = 0
    for k, nn in SHAPES:
        for x_dtype in (torch.bfloat16, torch.float32):
            for demand in (0, 2):
                x, planes, scales, _ = operands(torch, m, k, nn, gen, x_dtype, demand)
                variants = torch.tensor(ref.MASK_VARIANTS[demand:], dtype=torch.int32,
                                        device=gen.device)
                lane = variants[torch.randint(0, len(variants), (slots,), generator=gen,
                                              device=gen.device)]
                kw = dict(group_size=GROUP, sign_mag=True, plane_major=True)
                with dispatch.verify_row_blocks():
                    win_m = dispatch.packed_matmul(x, planes, scales, demand_drop=demand,
                                                   plane_mask=lane.repeat_interleave(W_VERIFY),
                                                   **kw)
                    win = dispatch.packed_matmul(x, planes, scales, **kw)
                for j in range(W_VERIFY):
                    xj = x[j::W_VERIFY].contiguous()
                    dec_m = dispatch.packed_matmul(xj, planes, scales, demand_drop=demand,
                                                   plane_mask=lane, **kw)
                    dec = dispatch.packed_matmul(xj, planes, scales, **kw)
                    if not (torch.equal(win_m[j::W_VERIFY], dec_m)
                            and torch.equal(win[j::W_VERIFY], dec)):
                        raise AssertionError(
                            f"row-blocked verify rows differ from decode rows at {slots} slots: "
                            f"K={k} N={nn} {x_dtype} demand={demand} position {j}")
                    n += 2
    return n


def speculative_wide(torch, gen, path: Path, cfg, slot_counts=WIDE_SLOTS,
                     device="cuda") -> None:
    """Full-width speculative streams at 16 and 40 slots, where the verify
    window (slots x 5 rows) exceeds SAME_PLAN_ROWS: tokens equal plain
    decode, every round drafts the reference's k (clamped by max_new only),
    the phase words equal the meter, and the verify's packed matmuls run in
    row blocks (K4 launched once per block)."""
    from repro_torch import api
    from repro_torch.kernels import dispatch, qsq, ref
    from repro_torch.kernels.qsq import SAME_PLAN_ROWS

    art = api.load(path, verify=True)
    sc = api.SpecConfig("lo", k=W_VERIFY - 1)
    rng = torch.Generator().manual_seed(2)
    for slots in slot_counts:
        n = check_block_rows(torch, gen, slots)
        say(f"  {slots} slots: row-blocked verify rows (M={slots * W_VERIFY}) == decode rows "
            f"(M={slots}) bit for bit: {n} checks")
        lengths = [5 + (59 * i) // (slots - 1) for i in range(slots)]
        prompts = [torch.randint(0, cfg.vocab, (ln,), generator=rng).tolist() for ln in lengths]
        quals = ["hi" if i % 2 == 0 else "mid" for i in range(slots)]
        spec = [(i // 2) % 2 == 0 for i in range(slots)]
        eng = art.engine(quality="mid", batch_slots=slots, device=device)
        plain_toks, _, plain_wall = _stream(torch, eng, prompts, quals, spec, None, slots)
        rounds = []

        def counted(orig):
            def verify(s, window, starts, wlen, smask, demand):
                clamp = {}
                for slot in smask.nonzero()[0].tolist():
                    req = s.sched.slot_req[slot]
                    clamp[slot] = (int(wlen[slot]) - 1,
                                   min(sc.k, req.max_new - len(req.out) - 1))
                before = (qsq.launches["qsq_matmul_masked"] + qsq.launches["qsq_matmul"],
                          dispatch.counters["gemm"])
                out = orig(s, window, starts, wlen, smask, demand)
                rounds.append((window.size, clamp,
                               qsq.launches["qsq_matmul_masked"] + qsq.launches["qsq_matmul"]
                               - before[0], dispatch.counters["gemm"] - before[1]))
                return out
            return verify

        _wrap(eng, "_verify_call", counted)
        qsq.reset_launches()
        ref.calls.clear()
        dispatch.reset_counters()
        try:
            toks, stats, wall = _stream(torch, eng, prompts, quals, spec, sc, slots)
        finally:
            del eng._verify_call
        words = eng._session.phase_words
        tr = dispatch.traffic
        if toks != plain_toks:
            bad = [i for i, (a, b) in enumerate(zip(toks, plain_toks, strict=True)) if a != b]
            raise AssertionError(f"{slots} slots: speculative tokens differ from plain decode "
                                 f"for requests {bad}")
        if sum(ref.calls.values()):
            raise AssertionError(f"plain versions ran: {dict(ref.calls)}")
        bad = [c for r in rounds for c in r[1].values() if c[0] != c[1]]
        if not rounds or bad:
            raise AssertionError(f"{slots} slots: drafted k != min(k, max_new - emitted - 1) "
                                 f"in {len(bad)} lanes of {len(rounds)} rounds: {bad[:4]}")
        drafted = sum(c[0] for r in rounds for c in r[1].values())
        if drafted != stats["drafted"] or drafted == 0:
            raise AssertionError(f"drafted {stats['drafted']} != {drafted} from the clamp")
        full = [r for r in rounds if r[0] == slots * W_VERIFY]
        blocks = -(-slots * W_VERIFY // SAME_PLAN_ROWS)
        calls = full[0][3] if full else 0
        if not calls or any(r[2:] != (blocks * calls, calls) for r in full):
            raise AssertionError(f"{slots} slots: full verifies launched "
                                 f"{[r[2:] for r in full]} (GEMMs, calls), not {blocks} a call")
        for phase in ("draft", "verify"):
            if (tr[f"phase:{phase}:plane_words_read"], tr[f"phase:{phase}:plane_words_full"]) \
                    != tuple(words[phase]):
                raise AssertionError(f"phase {phase} traffic != meter {words[phase]}")
        if 4 * tr["plane_words_read"] != stats["bytes_read"]:
            raise AssertionError("per-call dispatch traffic disagrees with the byte meter")
        say(f"  {slots} slots, {slots} requests x {MAX_NEW} tokens, half speculating with "
            f"SpecConfig('lo', {sc.k}): tokens identical to plain decode; drafted "
            f"{stats['drafted']} (every round's k == min(k, max_new - emitted - 1), "
            f"{len(rounds)} rounds), accepted {stats['accepted']}; phase words == meter "
            f"(verify {words['verify'][0]} of {words['verify'][1]})")
        say(f"  {slots} slots: each of {len(full)} full verifies (M={slots * W_VERIFY}) ran "
            f"{blocks} row blocks of <= {SAME_PLAN_ROWS} rows per packed matmul "
            f"({blocks * calls} GEMM launches for {calls} calls); tokens/s speculative "
            f"{stats['tokens'] / wall:.1f}, plain {slots * MAX_NEW / plain_wall:.1f}")
        say(f"  {slots} slots: row blocks re-read "
            f"{4 * tr['row_block_extra_plane_words']} B of weight planes beyond the "
            f"{4 * words['verify'][0]} B the verify's logical calls read "
            f"(+{100 * tr['row_block_extra_plane_words'] / max(words['verify'][0], 1):.1f}%)")
        del eng


# --------------------------------------------------------------------------
# Phase 9: the paper's own pipeline (LeNet, ConvNet4) on the card
# --------------------------------------------------------------------------
PAPER_RUNS = (("LENET", 300, 1024), ("CONVNET4", 150, 768))  # (config, steps, n)


def _view(w):
    """A leaf as its quantization view: 4-D conv -> (cin, kh * kw * cout)."""
    return w.movedim(2, 0).reshape(w.shape[2], -1) if w.dim() == 4 else w


def _same_codes(torch, name, params_cpu, q_card, q_cpu) -> int:
    """Card and CPU quantizations of one tree: scales within rtol 1e-6, codes
    equal except at nearest-level ties (|w / alpha| within 1e-5 of a level
    boundary).  Returns the number of tied codes."""
    from repro_torch.quant import is_store
    from repro_torch.tree import tree_leaves

    ties = 0
    leaves = zip(tree_leaves(params_cpu), tree_leaves(q_card.tree, is_leaf=is_store),
                 tree_leaves(q_cpu.tree, is_leaf=is_store), strict=True)
    for w, a, b in leaves:
        if not is_store(b):
            continue
        sa, sb = a.scales.cpu(), b.scales
        if not torch.allclose(sa, sb, rtol=1e-6, atol=0):
            raise AssertionError(f"{name}: card scales off the CPU's by "
                                 f"{float(((sa - sb) / sb).abs().max()):.2e} (rel)")
        diff = a.levels.cpu() != b.levels
        if bool(diff.any()):
            r = (_view(w) / b.scales.repeat_interleave(b.group_size, 0)).abs()[diff]
            gap = torch.stack([(r - t).abs() / t for t in (0.5, 1.5, 3.0)]).min(0).values
            if bool((gap > 1e-5).any()):
                raise AssertionError(f"{name}: {int((gap > 1e-5).sum())} codes differ "
                                     f"between card and CPU away from a tie")
            ties += int(diff.sum())
    return ties


def paper_pipeline(torch, workdir: Path, device="cuda") -> None:
    """LeNet and ConvNet4 at their published widths, trained on the card on
    the synthetic dataset: float accuracy, QSQ at phi = 1/2/4 (accuracy,
    Eq. 11/12 memory savings, zeros), CSD at k = 1/2/3, the artifact's
    tiers, the FC fine-tune, and the card's quantization against the CPU's
    on the same trained params."""
    from repro_torch.models import cnn

    # cuDNN's convolution backward and the loss's gather backward pick
    # non-deterministic kernels by default: the accuracies would move from
    # run to run
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, steps, n in PAPER_RUNS:
            _paper_model(torch, workdir, device, getattr(cnn, name), steps, n)
    finally:
        torch.use_deterministic_algorithms(False)


def _paper_model(torch, workdir: Path, device, cfg, steps: int, n: int) -> None:
    """One CNN: train, quantize at phi = 1/2/4 on the card and the CPU,
    CSD, the artifact's tiers."""
    from repro_torch import api
    from repro_torch.core.csd import csd_round, partial_product_savings
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.qsq import QSQConfig, zeros_fraction
    from repro_torch.models import cnn
    from repro_torch.quant import (
        dequantize_pytree,
        is_store,
        pytree_bits_report,
        quantize_pytree,
    )
    from repro_torch.train.cnn import finetune_fc, train_cnn
    from repro_torch.tree import tree_leaves, tree_map

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, tr_i, tr_l, ev_i, ev_l = train_cnn(cfg, steps=steps, n=n, seed=0,
                                               device=device)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    acc = cnn.cnn_accuracy(params, cfg, ev_i, ev_l)
    mats = [w for w in tree_leaves(params) if w.dim() >= 2]
    say(f"  {cfg.name}: {steps} steps (n={n}, seed 0) in {t_train:.2f} s, "
        f"{sum(w.numel() for w in tree_leaves(params))} params; float accuracy "
        f"{acc:.4f} on {len(ev_l)} held-out images")
    if not acc > 0.5:
        raise AssertionError(f"{cfg.name} did not learn: accuracy {acc}")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    z_fp = sum(float(zeros_fraction(w)) for w in mats) / len(mats)
    ties = 0
    for phi in (1, 2, 4):
        policy = QuantPolicy(base=QSQConfig(phi=phi, group_size=16), min_numel=256)
        qp = quantize_pytree(params, policy)
        acc_q = cnn.cnn_accuracy(dequantize_pytree(qp, like=params), cfg, ev_i, ev_l)
        rep = pytree_bits_report(params, qp)
        qs = [q for q in tree_leaves(qp.tree, is_leaf=is_store) if is_store(q)]
        z_q = sum(float(zeros_fraction(q.levels)) for q in qs) / len(qs)
        q_cpu = quantize_pytree(params_cpu, policy)
        if pytree_bits_report(params_cpu, q_cpu) != rep:
            raise AssertionError(f"{cfg.name} phi={phi}: bits reports differ, card vs CPU")
        ties += _same_codes(torch, f"{cfg.name} phi={phi}", params_cpu, qp, q_cpu)
        if not 0.0 < rep["memory_savings"] < 1.0 or not acc_q >= 0.0:
            raise AssertionError(f"{cfg.name} phi={phi}: report {rep}")
        say(f"    phi={phi}: accuracy {acc_q:.4f} (drop {acc - acc_q:+.4f}), memory savings "
            f"{100 * rep['memory_savings']:.2f}% ({rep['n_quantized_leaves']} of "
            f"{rep['n_leaves']} leaves), zeros {100 * z_fp:.2f}% -> {100 * z_q:.2f}%")
        if phi == 1:
            tuned = finetune_fc(dequantize_pytree(qp, like=params), cfg, tr_i, tr_l)
            say(f"    phi=1 + FC fine-tune (60 steps): accuracy "
                f"{cnn.cnn_accuracy(tuned, cfg, ev_i, ev_l):.4f}")
    say(f"    card vs CPU quantization of the same params, phi = 1/2/4: bits reports "
        f"equal, scales within rtol 1e-6, codes equal except {ties} nearest-level ties")
    w = torch.cat([m.reshape(-1) for m in mats])
    for k in (1, 2, 3):
        mse = float(((w - csd_round(w, k)) ** 2).mean())
        pps = float(partial_product_savings(w, k))
        say(f"    CSD k={k}: mse {mse:.3e}, partial products skipped {100 * pps:.1f}% "
            f"(all {w.numel()} weights)")
    path = api.compress(None, params, device=device).save(workdir / f"{cfg.name}.edge.npz")
    art = api.load(path, verify=True)
    accs = {t: cnn.cnn_accuracy(art.dense_params(t, like=params, device=device), cfg,
                                ev_i, ev_l) for t in art.quality_names()}
    say(f"    compress(None) -> save ({path.stat().st_size / 1e3:.1f} kB) -> load -> "
        f"dense_params: accuracy " + ", ".join(f"{t} {a:.4f}" for t, a in accs.items()))
    path.unlink()


# --------------------------------------------------------------------------
# Phase 10: serving from pack_params (interleaved Table II planes)
# --------------------------------------------------------------------------
def _packed_run(torch, model, tp, toks, steps: int):
    """Model.prefill of ``toks`` then ``steps`` greedy Model.decode steps ->
    (tokens (B, steps + 1), logits (steps + 1, B, V) on the CPU, decode ms)."""
    from repro_torch.models.base import init_params

    dev = toks.device
    b, s = toks.shape
    cache = init_params(model.cache_descs(b, s + steps + 1), device=dev)
    cache, last = model.prefill(tp, cache, toks)
    outs, logits, ms = [], [last], []
    cur = torch.argmax(last, -1).to(torch.int32)[:, None]
    for _ in range(steps):
        outs.append(cur)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode(tp, cache, {"tokens": cur})
        cur = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[:, -1])
    outs.append(cur)
    return (torch.cat(outs, 1).cpu(), torch.stack([x.float().cpu() for x in logits]),
            statistics.median(ms))


def _check_table2(tp) -> int:
    from repro_torch.quant import PackedWeight, is_store
    from repro_torch.tree import tree_leaves

    packed = [x for x in tree_leaves(tp, is_leaf=is_store) if isinstance(x, PackedWeight)]
    if not packed or any(x.sign_mag or x.plane_major for x in packed):
        raise AssertionError("pack_params must give interleaved Table II planes")
    return len(packed)


PACKED_SLOTS, PACKED_PROMPT, PACKED_GROUP = 8, 16, 64


def packed_path(torch, gen, cfg, steps=6, device="cuda") -> tuple[dict, dict]:
    """Full-width smollm-135m (random init, seed 0) packed by pack_params
    (G = 64, min_numel 65536) and served through Model.prefill (K3) and
    Model.decode (K1) on Table II planes; then the 2-layer d64 config
    against the CPU path.  First K1 and K3 are held against their plain
    versions at this path's M, group size and layout.  Returns the path's
    launches and that check's worst |kernel - plain| per kernel."""
    from repro_torch.kernels import qsq, ref
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params
    from repro_torch.quant.packed import pack_params
    from repro_torch.tree import tree_map

    errs = {}
    n = check_kernels(torch, gen, cases=[("qsq_matvec", PACKED_SLOTS),
                                         ("qsq_matmul", PACKED_SLOTS * PACKED_PROMPT)],
                      sign_mag=False, plane_major=False, group=PACKED_GROUP, errs=errs)
    say(f"  K1 at M={PACKED_SLOTS} and K3 at M={PACKED_SLOTS * PACKED_PROMPT}, G={PACKED_GROUP}, "
        f"Table II layout: {n} checks within the f32 bound (five shapes, bf16 and f32 x); "
        f"max |kernel - plain| K1 {errs['qsq_matvec']:.3e}, K3 {errs['qsq_matmul']:.3e}")
    model = Model(cfg)
    descs = model.param_descs()
    params = init_params(descs, torch.Generator(device=device).manual_seed(0), device=device)
    tp = pack_params(params, descs, group_size=PACKED_GROUP, min_numel=65536)
    del params
    n_packed = _check_table2(tp)
    toks = torch.randint(0, cfg.vocab, (PACKED_SLOTS, PACKED_PROMPT),
                         generator=torch.Generator().manual_seed(3), dtype=torch.int32).to(device)
    qsq.reset_launches()
    ref.calls.clear()
    runs = [_packed_run(torch, model, tp, toks, steps) for _ in range(2)]
    launches = dict(qsq.launches)
    if sum(ref.calls.values()):
        raise AssertionError(f"plain versions ran on the pack_params path: {dict(ref.calls)}")
    if not launches.get("qsq_matmul") or not launches.get("qsq_matvec") or \
            launches.get("qsq_matmul_masked") or launches.get("qsq_matvec_masked"):
        raise AssertionError(f"pack_params path launches: {launches}")
    if not torch.equal(runs[0][0], runs[1][0]):
        raise AssertionError("two pack_params runs gave different greedy tokens")
    if not bool(torch.isfinite(runs[0][1]).all()):
        raise AssertionError("pack_params logits are not finite")
    per_step = (launches["qsq_matvec"] // 2 - 1) // steps  # the prefill's head is one K1
    say(f"  full width: {n_packed} packed leaves (interleaved Table II, sign_mag=False); "
        f"prefill {PACKED_SLOTS} x {PACKED_PROMPT} (K3 at M={PACKED_SLOTS * PACKED_PROMPT}) + "
        f"{steps} decode steps at {PACKED_SLOTS} slots, twice: tokens "
        f"identical, logits finite; kernels launched {launches}, plain versions 0")
    say(f"  decode step: median {runs[1][2]:.2f} ms (host clock, synchronized), "
        f"{per_step} K1 launches per step")

    d64, params = d64_model_params(torch)
    out = {}
    for dev in ("cpu", device):
        tpd = pack_params(tree_map(lambda t, d=dev: t.to(d), params), d64.param_descs(),
                          group_size=16, min_numel=1024)
        _check_table2(tpd)
        t = torch.tensor([[5, 9, 2, 8], [1, 2, 3, 4], [7, 7, 0, 250]], dtype=torch.int32)
        out[dev] = _packed_run(torch, d64, tpd, t.to(dev), 4)
    if not torch.equal(out["cpu"][0], out[device][0]):
        raise AssertionError(f"d64 pack_params tokens differ, card vs CPU:\n{out['cpu'][0]}\n"
                             f"{out[device][0]}")
    diff = (out[device][1] - out["cpu"][1]).abs()
    if not bool((diff <= 1e-4 + 1e-4 * out["cpu"][1].abs()).all()):
        raise AssertionError(f"d64 pack_params logits off the CPU's by {float(diff.max()):.3e}")
    say(f"  d64 (2 layers, f32): pack_params tokens identical on card and CPU, logits max "
        f"|diff| {float(diff.max()):.3e} (1e-4 abs + rel)")
    return launches, errs


# --------------------------------------------------------------------------
# Phase 11: the other dense configs
# --------------------------------------------------------------------------
def phi4_full_width(torch, workdir: Path) -> dict:
    """phi4-mini-3.8b at its published widths and depth (random weights from
    seed 0) through the main path: compress, save, load(verify=True),
    engine(quality="mid"), the mixed-tier stream eager and captured (K1-K4),
    then a speculative stream whose tokens equal plain decode."""
    from repro_torch import api
    from repro_torch.configs import get_arch

    cfg = get_arch("phi4_mini_3_8b")
    art, path, t_save, t_load = compress_saved(torch, workdir, cfg, "phi4_mini_3_8b")
    say(f"  phi4-mini-3.8b ({cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}): "
        f"artifact {path.stat().st_size / 2**30:.2f} GiB, compress+save {t_save:.1f} s, "
        f"load(verify) {t_load:.1f} s")
    path.unlink()
    e, c, eng = eager_and_captured(torch, art, cfg, "phi4-mini-3.8b")
    graph_logits_equal(torch, eng, "phi4-mini-3.8b")
    prompts = stream_prompts(torch, cfg)[:8]
    quals = ["hi" if i % 2 == 0 else "mid" for i in range(8)]
    spec = [(i // 2) % 2 == 0 for i in range(8)]
    sc = api.SpecConfig("lo", k=W_VERIFY - 1)
    _stream(torch, eng, prompts, quals, spec, None)  # the captures of both streams
    plain, _, plain_wall = _stream(torch, eng, prompts, quals, spec, None)
    _stream(torch, eng, prompts, quals, spec, sc)
    toks, stats, wall = _stream(torch, eng, prompts, quals, spec, sc)
    if toks != plain or stats["drafted"] == 0:
        raise AssertionError(f"phi4-mini speculative tokens differ from plain decode "
                             f"(drafted {stats['drafted']})")
    say(f"  phi4-mini-3.8b: 8 requests x {MAX_NEW} tokens, half speculating with "
        f"SpecConfig('lo', {sc.k}), captured: tokens identical to plain decode; drafted "
        f"{stats['drafted']}, accepted {stats['accepted']}; tokens/s speculative "
        f"{stats['tokens'] / wall:.1f}, plain {len(prompts) * MAX_NEW / plain_wall:.1f}")
    eager = art.engine(quality="mid", batch_slots=8, device="cuda", eager=True)
    for label, en in (("eager", eager), ("captured", eng)):
        profile_decode(torch, en, prompts, TIER_NAMES, label=f"phi4-mini {label}")
    del eager, eng, art
    return c["launches"]


def reduced_full_width(torch, workdir: Path) -> None:
    """qwen3-14b and deepseek-7b at their published widths, cut to 2 layers
    (random weights from seed 0), served a few greedy tokens at mixed tiers
    through the captured engine (K1-K4, the long-K ``wd`` on the GEMM's
    16-row tiles); then each smoke config of the three other dense configs
    gives the CPU's tokens on the card."""
    import gc

    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.kernels import qsq, ref
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    for arch in ("qwen3_14b", "deepseek_7b"):
        full = get_arch(arch)
        cfg = dataclasses.replace(full, n_layers=2)
        model = Model(cfg)
        params = init_params(model.param_descs(), torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        art = api.compress(model, params, tiers=serving_tiers(api), device="cuda")
        del params
        eng = art.engine(quality="mid", batch_slots=4, device="cuda")
        rng = torch.Generator().manual_seed(6)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
                   for n in (5, 17, 40, 64)]
        out = []
        for run in range(2):  # the second run replays the first one's graphs
            qsq.reset_launches()
            ref.calls.clear()
            eng.reset_stream()
            rids = [eng.submit(p, max_new=4, quality=TIER_NAMES[i % 3])
                    for i, p in enumerate(prompts)]
            eng.run_until_drained()
            out.append([eng.poll(r).tokens for r in rids])
        launches = dict(qsq.launches)
        if out[0] != out[1] or not all(len(t) == 4 and all(0 <= x < cfg.vocab for x in t)
                                       for t in out[1]):
            raise AssertionError(f"{cfg.name} (2 layers): tokens {out}")
        missing = [k for k in KERNELS if not launches.get(k)]
        fma = {k: v for k, v in launches.items() if k.endswith(":fma")}
        if missing or fma or sum(ref.calls.values()):
            raise AssertionError(f"{cfg.name} (2 layers): kernels missing {missing}, FMA "
                                 f"route {fma}, plain versions {dict(ref.calls)}")
        say(f"  {full.name} reduced: n_layers {full.n_layers} -> 2 at the published widths "
            f"(d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab}); 4 mixed-tier requests x 4 greedy tokens, captured, twice: "
            f"identical, in vocab; launches {launches}; FMA route 0, plain versions 0")
        del eng, art
        gc.collect()
        torch.cuda.empty_cache()
    for arch in ("phi4_mini_3_8b", "qwen3_14b", "deepseek_7b"):
        card_vs_cpu(torch, workdir, cfg=get_arch(arch, smoke=True))


# --------------------------------------------------------------------------
# Phase 12: the MoE family
# --------------------------------------------------------------------------
MOE_ARCH = "qwen3_moe_30b_a3b"
MOE_LAYERS = 8  # of 48: compressing needs the dense tree and its codes at once


def moe_full_width(torch, workdir: Path) -> dict:
    """qwen3-moe-30b-a3b at its published widths cut to ``MOE_LAYERS`` layers
    (random weights from seed 0) through the main path: compress, save,
    load(verify=True), engine(quality="mid"), the mixed-tier stream eager
    and captured (K1-K4 on wq/wk/wv and the head; the experts dense,
    batched over experts), replayed logits equal eager; a speculative
    stream; the split of a decode step's device time.  Then the MoE smoke
    config gives the CPU's tokens on the card.  Returns the captured
    stream's launches."""
    import gc

    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.kernels import dispatch

    gc.collect()  # the earlier phases' engines and graph pools
    torch.cuda.empty_cache()
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    e_bytes = 3 * cfg.moe.n_experts * cfg.d_model * cfg.d_ff * 2 * cfg.n_layers
    say(f"  reduced: n_layers {full.n_layers} -> {cfg.n_layers}, nothing else (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.hd}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} of d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16); dense bf16 experts "
        f"{e_bytes / 1e9:.2f} GB, {e_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms a decode step at the "
        f"byte bound")
    torch.cuda.reset_peak_memory_stats()
    art, path, t_save, t_load = compress_saved(torch, workdir, cfg, MOE_ARCH)
    say(f"  artifact {path.stat().st_size / 2**30:.3f} GiB, compress+save {t_save:.1f} s, "
        f"load(verify) {t_load:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    path.unlink()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, c, eng = eager_and_captured(torch, art, cfg, "qwen3-moe-30b-a3b")
    graph_logits_equal(torch, eng, "qwen3-moe-30b-a3b")

    prompts = stream_prompts(torch, cfg)[:8]
    quals = ["hi" if i % 2 == 0 else "mid" for i in range(8)]
    spec = [(i // 2) % 2 == 0 for i in range(8)]
    sc = api.SpecConfig("lo", k=W_VERIFY - 1)
    _stream(torch, eng, prompts, quals, spec, None)  # the captures of both streams
    plain, _, plain_wall = _stream(torch, eng, prompts, quals, spec, None)
    _stream(torch, eng, prompts, quals, spec, sc)
    dispatch.reset_counters()
    toks, stats, wall = _stream(torch, eng, prompts, quals, spec, sc)
    words, tr = eng._session.phase_words, dispatch.traffic
    for phase in ("draft", "verify"):
        if (tr[f"phase:{phase}:plane_words_read"], tr[f"phase:{phase}:plane_words_full"]) != \
                tuple(words[phase]):
            raise AssertionError(f"qwen3-moe phase {phase} traffic != meter {words[phase]}")
    if stats["drafted"] == 0:
        raise AssertionError("qwen3-moe: no request drafted")
    same = sum(a == b for a, b in zip(toks, plain, strict=True))
    say(f"  qwen3-moe-30b-a3b: 8 requests x {MAX_NEW} tokens, half speculating with "
        f"SpecConfig('lo', {sc.k}), captured: drafted {stats['drafted']}, accepted "
        f"{stats['accepted']}; phase words == meter; {same} of 8 token lists equal plain "
        f"decode (a finding, not a check: capacity routing couples lanes); tokens/s "
        f"speculative {stats['tokens'] / wall:.1f}, plain "
        f"{len(prompts) * MAX_NEW / plain_wall:.1f}")
    eager = art.engine(quality="mid", batch_slots=8, device="cuda", eager=True)
    profile_moe_decode(torch, eager, eng, prompts)
    say(f"  peak device memory while serving (two engines' dense experts): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eager, eng, art
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu(torch, workdir, cfg=get_arch(MOE_ARCH, smoke=True))
    return c["launches"]


MOE_RANGES = {"expert_ffn": "expert bmm", "moe_route": "routing", "moe": "routing",
              "_gqa_scores_apply": "attention"}


@contextlib.contextmanager
def _ranged(torch, module, names):
    """Wrap ``module``'s functions ``names`` in profiler ranges (callers in
    the module look them up at each call)."""
    saved = {n: getattr(module, n) for n in names}

    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(module, n, ranged(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _category(evt, ranges=MOE_RANGES) -> str:
    """The innermost of ``ranges`` around a profiled op, else rest."""
    while evt is not None:
        if evt.name in ranges:
            return ranges[evt.name]
        evt = evt.cpu_parent
    return "rest"


def _decode_prof(torch, eng, prompts, steps, ranges=False):
    """A profile of ``steps`` decode steps at 8 live slots (mixed tiers)
    -> (prof, wall us a step)."""
    from torch.profiler import ProfilerActivity, profile

    eng.reset_stream()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=steps + 4, quality=TIER_NAMES[i % 3])
    eng.step()  # admits every prompt, then one decode
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if ranges:
            from repro_torch.models import layers

            stack.enter_context(_ranged(torch, layers, MOE_RANGES))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    eng.run_until_drained()
    return prof, wall_us


def profile_moe_decode(torch, eager, eng, prompts, steps=2, label="qwen3-moe"):
    """The device time of a decode step split into K1/K2 (by kernel name),
    the expert products, routing (softmax, top-k, sort, the dispatch
    scatter and the combine's gather), attention (scores, softmax, PV) and
    the rest.  In the eager step each kernel takes the category of the
    layer function that launched it (profiler ranges); the captured step
    replays the same kernels, and each of its kernel names takes the
    category that held most of that name's eager time."""
    from torch.autograd import DeviceType

    kinds = ("K1/K2", "expert bmm", "routing", "attention", "rest")
    prof, e_wall = _decode_prof(torch, eager, prompts, steps, ranges=True)
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU:
            continue
        for k in evt.kernels:
            if not kernel_of(k.name):
                d = by_name.setdefault(k.name, dict.fromkeys(kinds, 0.0))
                d[_category(evt)] += k.duration
    name_kind = {n: max(d, key=d.get) for n, d in by_name.items()}

    def split(kern, exact):
        out = dict.fromkeys(kinds, 0.0)
        for key, t, _ in kern:
            if kernel_of(key):
                out["K1/K2"] += t
            elif exact and key in by_name:
                for kind, u in by_name[key].items():
                    out[kind] += u
                out["rest"] += t - sum(by_name[key].values())
            else:
                out[name_kind.get(key, "rest")] += t
        return out

    cprof, c_wall = _decode_prof(torch, eng, prompts, steps)
    # the ranges show up as device annotations spanning their kernels
    e_kern = [r for r in device_kernels(prof) if r[0] not in MOE_RANGES]
    for mode, kern, wall, exact in (("eager", e_kern, e_wall, True),
                                    ("captured", device_kernels(cprof), c_wall, False)):
        sp, busy = split(kern, exact), sum(t for _, t, _ in kern)
        parts = ", ".join(f"{k} {sp[k] / steps / 1e3:.3f} ms "
                          f"({100 * sp[k] / max(busy, 1e-9):.1f}%)" for k in kinds)
        say(f"  {label} {mode} decode step (8 slots, profiled): wall {wall / 1e3:.2f} ms, "
            f"device busy {busy / steps / 1e3:.3f} ms ({100 * busy / steps / wall:.1f}% of "
            f"wall), {sum(n for _, _, n in kern) // steps} launches; {parts}")
        for name, t, n in sorted(kern, key=lambda r: -r[1])[:8]:
            kind = "K1/K2" if kernel_of(name) else name_kind.get(name, "rest")
            say(f"    {t / steps / 1e3:7.3f} ms/step  {n // steps:5d} launches/step  [{kind}] "
                f"{name[:80]}")


# --------------------------------------------------------------------------
# Phase 13: the sliding-window ring (mixtral-8x22b)
# --------------------------------------------------------------------------
MIX_ARCH = "mixtral_8x22b"
MIX_LAYERS = 2  # of 56: the same 9.66 GB of dense bf16 experts as [12]'s 8 layers
MIX_PREFILL, MIX_NEW = 4064, 64  # every lane's decode crosses cache index 4096
FWD_LEN = 8192  # the forward's padded length: more than window + q_chunk (kv slices)
RING_ATTN_TOL = 1e-5  # |ring - attention| over max |attention|: one layer, unit score spread
RING_TOL = 1e-6  # |ring - forward| over max |logit|: f64 (logits end f32), routed alike
RING_LANES = (0, 1, 3, 4, 9, 10)  # hi and mid (a lo lane's head drops every plane: logits 0)


def ring_prompts(torch, cfg, seed=1):
    """The 12 prompts of [13]'s stream, 3900 to 4064 tokens: with 63
    decodes the last three outlive the 4096-token window."""
    rng = torch.Generator().manual_seed(seed)
    lengths = [3900 + (164 * i) // 11 for i in range(12)]
    return [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist() for n in lengths]


def _tier_tree(torch, params, tier: int):
    """The served tree at tier index ``tier`` with its packed leaves decoded
    to f32 (planes truncated as the tier's row masks drop them); the dense
    leaves are the engine's own tensors."""
    from repro_torch.quant.store import PackedWeight, is_store
    from repro_torch.tree import tree_map

    def leaf(p):
        if isinstance(p, PackedWeight):
            drop = p.tier_drops[tier] if p.tier_drops else 0
            return p.truncate(drop).as_dense(torch.float32)
        return p

    return tree_map(leaf, params, is_leaf=is_store)


def _drop_oldest(torch, ring):
    """A planted fault: the ring's mask one entry short (the oldest of the
    last ``min(pos + 1, t)`` writes left out)."""
    def faulty(pos, pad, t):
        slot, valid = ring(pos, pad, t)
        age = (slot[:, None] - torch.arange(t, device=pos.device)[None, :]) % t
        return slot, valid & (age < torch.clamp(pos + 1, max=t)[:, None] - 1)
    return faulty


def _write_ahead(torch, ring):
    """A planted fault: the step's k/v written one slot past ``pos % t``."""
    def faulty(pos, pad, t):
        slot, valid = ring(pos, pad, t)
        return (slot + 1) % t, valid
    return faulty


def ring_attention(torch, eng, prompts, cfg) -> None:
    """The ring itself against windowed attention at mixtral's widths, one
    attention layer at a time, on the same inputs: seeded random rows (one
    lane per prompt, its length plus ``MIX_NEW - 1``) go through
    ``layers.attention`` (padded to ``FWD_LEN``: the kv-sliced branch) and
    through the ring as the engine runs it (``prefill_attention`` of a
    left-padded ``MIX_PREFILL``-wide prompt per lane, then the 12 lanes
    decoding together, each at its own ``pos``/``pad``, past the 4096-entry
    ring's wrap; the last three lanes evict real keys).  The random
    weights' q and k are ~11x those of a 1 / sqrt(d) init (``fan_in`` of a
    (d, heads, hd) weight is its heads, as in the JAX package), so at
    unit-RMS inputs the scores spread over hundreds and attention is nearly
    one-hot: a key left out would rarely show, and f32 noise is amplified.
    The rows are scaled so that each layer's scores have unit spread; then
    every key in the window carries weight.  In f64 and in f32 (the softmax
    runs in f32 on both sides) the outputs and the k/v left in the ring
    agree within ``RING_ATTN_TOL`` of the largest |value|, and two planted
    ring faults (:func:`_drop_oldest`, :func:`_write_ahead`) must each
    exceed it in f64."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import layer_params

    dev, d, t = eng.device, cfg.d_model, cfg.window
    n_dec = MIX_NEW - 1
    lens = [len(p) for p in prompts]
    blocks = _tier_tree(torch, eng.params, 0)["blocks"]
    ring = layers.ring_entries
    faults = {"drop_oldest": _drop_oldest(torch, ring), "write_ahead": _write_ahead(torch, ring)}
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    caught = {k: [] for k in faults}
    kw = dict(theta=cfg.rope_theta, window=cfg.window)

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    def spread(p, x):  # std of the scores q.k / sqrt(hd) among rows x (S, d), no RoPE
        q, k, _ = layers._project_qkv(p, x[None], None, cfg.rope_theta)
        qg = q[0].reshape(x.shape[0], cfg.n_kv, -1, cfg.hd)
        return float((torch.einsum("skgh,tkh->kgst", qg, k[0]) / cfg.hd ** 0.5).std())

    g = torch.Generator(device=dev).manual_seed(3)
    unit = torch.randn((512, d), generator=g, device=dev)
    with torch.no_grad():
        spreads = [spread(layer_params(blocks, li)["attn"], unit) for li in range(cfg.n_layers)]
    for dt in worst:
        g = torch.Generator(device=dev).manual_seed(3)
        base = [torch.randn((n + n_dec, d), generator=g, device=dev, dtype=dt) for n in lens]
        for li in range(cfg.n_layers):
            p = layer_params(blocks, li)["attn"]
            xs = [x * spreads[li] ** -0.5 for x in base]
            ref, kref, vref, pre, kv0 = [], [], [], [], []
            with torch.no_grad():
                for n, x in zip(lens, xs):
                    xf = torch.zeros((1, FWD_LEN, d), device=dev, dtype=dt)
                    xf[0, :len(x)] = x
                    at = torch.arange(FWD_LEN, device=dev)[None]
                    ref.append(layers.attention(p, xf, positions=at, **kw)[0, :len(x)])
                    _, kf, vf = layers._project_qkv(p, xf, at, cfg.rope_theta)
                    kref.append(kf[0, :len(x)])
                    vref.append(vf[0, :len(x)])
                    pad = MIX_PREFILL - n
                    xp = torch.zeros((1, MIX_PREFILL, d), device=dev, dtype=dt)
                    xp[0, pad:] = x[:n]
                    at = torch.clamp(torch.arange(MIX_PREFILL, device=dev) - pad, min=0)[None]
                    z = torch.zeros((1, t, cfg.n_kv, cfg.hd), device=dev, dtype=dt)
                    y, c = layers.prefill_attention(
                        p, xp, layers.KVCache(k=z, v=z, pos=None, pad=None), positions=at,
                        pad=torch.full((1,), pad, dtype=torch.int32, device=dev), **kw)
                    pre.append(y[0, pad:])
                    kv0.append(c)
                for fault in (None, *faults) if dt == torch.float64 else (None,):
                    cache = layers.KVCache(*(torch.cat([getattr(c, f) for c in kv0])
                                             for f in layers.KVCache._fields))
                    layers.ring_entries = faults[fault] if fault else ring
                    try:
                        dec = []
                        for j in range(n_dec):
                            xj = torch.stack([x[n + j] for n, x in zip(lens, xs)])[:, None]
                            y, cache = layers.decode_attention(p, xj, cache, **kw)
                            dec.append(y[:, 0])
                    finally:
                        layers.ring_entries = ring
                    dec = torch.stack(dec, 1)
                    errs = []
                    for b, n in enumerate(lens):
                        errs.append(rel(torch.cat([pre[b], dec[b]]), ref[b]))
                        if fault is None:
                            # the lane's last t writes that are not pad, at slots g % t
                            top, pad = MIX_PREFILL + n_dec, MIX_PREFILL - n
                            gl = torch.arange(max(top - t, pad), top, device=dev)
                            errs.append(rel(cache.k[b, gl % t], kref[b][gl - pad]))
                            errs.append(rel(cache.v[b, gl % t], vref[b][gl - pad]))
                    if fault is None:
                        worst[dt] = max(worst[dt], max(errs))
                    else:
                        caught[fault].append(max(errs))
            del ref, kref, vref, pre, kv0, xs
    for dt, w in worst.items():
        if w > RING_ATTN_TOL:
            raise AssertionError(f"the ring's attention off windowed attention by {w:.3e} of "
                                 f"the largest value ({dt}) > {RING_ATTN_TOL}")
    for fault, errs in caught.items():
        if min(errs) <= RING_ATTN_TOL:
            raise AssertionError(f"a planted ring fault ({fault}) passes the ring check: "
                                 f"{errs} within {RING_ATTN_TOL}")
    say(f"  the ring's attention vs windowed attention, both layers' weights, {len(lens)} "
        f"lanes of random rows ({lens[0]}-{lens[-1]} + {n_dec}: per-lane prefill, then "
        f"batched decode across the wrap, the last 3 lanes evicting), the scores' spread at "
        f"unit-RMS rows " + " / ".join(f"{v:.1f}" for v in spreads) + " (layers), scaled "
        f"to 1: outputs and the ring's k/v within {worst[torch.float64]:.3e} (f64) and "
        f"{worst[torch.float32]:.3e} (f32) of the largest value (tolerance {RING_ATTN_TOL}); "
        f"planted faults in f64: " + ", ".join(f"{k} {min(v):.3e}" for k, v in caught.items())
        + " (each caught)")


class _Recorder:
    """While installed, records what ``layers.<name>`` returns (its first
    output; for ``moe_route`` the (T, k) experts, and their weights under
    ``"weight"``), call by call; ``route`` replaces the routing
    (:func:`_forced_route`)."""

    def __init__(self, torch, names=("attention", "prefill_attention", "decode_attention",
                                     "moe_route"), route=None):
        from repro_torch.models import layers

        self.torch, self.layers, self.names, self.route = torch, layers, names, route
        self.calls = {n: [] for n in (*names, "weight")}
        self.orig = {n: getattr(layers, n) for n in names}

    def _call(self, name, *a, **kw):
        if name != "moe_route":
            out = self.orig[name](*a, **kw)
            self.calls[name].append(out[0] if isinstance(out, tuple) else out)
            return out
        t, k = a[1].shape[0], kw["top_k"]
        if self.route is None:
            out = self.orig[name](*a, **kw)
        else:
            out = self.route(self.orig[name], len(self.calls[name]), *a, **kw)
        self.calls[name].append(out[0].expert.view(t, k))
        self.calls["weight"].append(out[0].weight.view(t, k))
        return out

    def __enter__(self):
        for n in self.names:
            setattr(self.layers, n, lambda *a, _n=n, **kw: self._call(_n, *a, **kw))
        return self

    def __exit__(self, *exc):
        for n in self.names:
            setattr(self.layers, n, self.orig[n])

    def rows(self, name, nl, n, pad=None, steps=None):
        """Per layer, the recorded rows of the first ``n`` real positions:
        of a forward (one call per layer; ``pad`` None), or of a ring run
        (one prefill call per layer, its first ``pad`` rows cut, then one
        call per layer a decode step: the calls of ``steps``, by default
        ``name``'s after the prefill's)."""
        calls = self.calls[name]

        def flat(c):  # (1, S, d) -> (S, d); experts and weights (T, k) as they are
            return c.reshape(-1, c.shape[-1]) if c.dim() == 3 else c

        if pad is None:
            return [flat(c)[:n] for c in calls[:nl]]
        dec = calls[nl:] if steps is None else self.calls[steps]
        return [self.torch.cat([flat(calls[li])[pad:]] + [flat(c) for c in dec[li::nl]])[:n]
                for li in range(nl)]


def _forced_route(torch, want, weights, moved):
    """A ``moe_route`` that takes the experts ``want[layer]`` (n, k) and
    their weights ``weights[layer]`` for the first n tokens (the rest route
    as they would), placed in token-major order; ``moved`` collects, per
    call, the tokens whose own choice of experts was another."""
    def route(orig, layer, router, xt, *, top_k, cap, active=None):
        from repro_torch.models.layers import Routing

        r, aux = orig(router, xt, top_k=top_k, cap=cap, active=active)
        t, e, n = xt.shape[0], router.shape[-1], want[layer].shape[0]
        ex = r.expert.view(t, top_k).clone()
        w = r.weight.view(t, top_k).clone()
        moved.append(int((ex[:n].sort(-1).values != want[layer].sort(-1).values)
                         .any(-1).sum()))
        ex[:n], w[:n] = want[layer], weights[layer]
        flat = ex.reshape(-1)
        order = torch.argsort(flat, stable=True)
        starts = torch.searchsorted(flat[order], torch.arange(e, dtype=flat.dtype,
                                                              device=xt.device), side="left")
        pos = torch.argsort(order) - starts[flat]
        return Routing(expert=flat, pos=pos, keep=pos < cap, weight=w.reshape(-1)), aux
    return route


@contextlib.contextmanager
def _f64_reference(torch):
    """While installed, ``layers._gqa_scores_apply`` runs its softmax and
    ``layers.rmsnorm`` its reduction in the input's own dtype (the port's,
    as the JAX package's, cast to f32 first), for an f64 reference of both
    sides: an f32 sum's order depends on the tensor's shape on the card."""
    from repro_torch.models import layers

    orig = layers._gqa_scores_apply, layers.rmsnorm

    def apply(q, k, v, mask):
        b, s, h, hd = q.shape
        qg = q.reshape(b, s, k.shape[2], h // k.shape[2], hd)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / hd ** 0.5
        scores = torch.where(mask, scores, torch.full((), -1e30, dtype=scores.dtype,
                                                      device=scores.device))
        out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(scores, dim=-1), v)
        return out.reshape(b, s, h, hd)

    def rmsnorm(x, scale, eps=1e-6):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.to(x.dtype)

    layers._gqa_scores_apply, layers.rmsnorm = apply, rmsnorm
    try:
        yield
    finally:
        layers._gqa_scores_apply, layers.rmsnorm = orig


def _ring_logits(torch, model, params, prompt, tier: int, dev, feed=None):
    """One request through the ring as the engine runs it (a left-padded
    ``MIX_PREFILL``-wide admission, then decode steps at its tier) ->
    (logits (MIX_NEW, V) f32, tokens): greedy, or fed ``feed``."""
    from repro_torch.models.base import init_params

    cache = init_params(model.cache_descs(1, MIX_PREFILL + MIX_NEW + 1), device=dev)
    toks = torch.zeros((1, MIX_PREFILL), dtype=torch.int32)
    toks[0, MIX_PREFILL - len(prompt):] = torch.tensor(prompt, dtype=torch.int32)
    tiers = torch.full((1,), tier, dtype=torch.int32, device=dev)
    lens = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    cache, last = model.prefill(params, cache, toks.to(dev), lens, tiers, tier)
    rows, out = [last[0]], []
    for j in range(MIX_NEW):
        out.append(int(rows[-1].argmax()) if feed is None else feed[j])
        if j + 1 < MIX_NEW:
            cur = torch.tensor([[out[-1]]], dtype=torch.int32, device=dev)
            lg, cache = model.decode(params, cache, {"tokens": cur, "tiers": tiers,
                                                     "demand": tier})
            rows.append(lg[0, -1])
    return torch.stack(rows).float(), out


def ring_vs_forward(torch, eng, prompts, cfg) -> None:
    """The whole model through the ring against the windowed full-sequence
    forward, lanes ``RING_LANES`` (hi and mid tiers; 9 and 10 outlive the
    window).  Both sides run mixtral's layers at a capacity factor of E / k,
    at which no assignment drops (capacity routing would otherwise route a
    whole sequence otherwise than an admission).  The ring path
    (``Model.prefill`` and ``Model.decode`` at the lane's tier: a 4064-wide
    left-padded admission, then 63 decodes across the wrap) picks greedy
    tokens in bf16 on the engine's served params; the forward
    (``lm_forward``, right-padded to ``FWD_LEN``: the kv-sliced branch)
    runs over the prompt and those tokens.
    * f64, on the tier's decoded tree, the softmax and the norms in f64 on
      both sides (:func:`_f64_reference`): the ring's logits agree
      with the forward's within ``RING_TOL`` of the largest |logit| (each
      lane's largest is nonzero).  The forward takes the ring's experts and
      weights token by token (:func:`_forced_route`: the f32 router's
      products differ in their last bits between shapes); how many tokens
      its own router would have sent elsewhere is printed.
    * f32 (printed, not held): the engine's served params through the ring
      against the f32 forward, beside the f32 forward's own distance from
      the f64 one, with each layer's attention output gap.  At random
      weights attention is nearly one-hot (:func:`ring_attention`), and
      each layer amplifies rounding, so two f32 orders of one function
      differ by ~1e-4 to 1e-3 of the largest |logit|.
    * The two planted ring faults of :func:`ring_attention`, on the last
      lane (it evicts): ``write_ahead`` must exceed the bound;
      ``drop_oldest`` is printed, since at nearly one-hot attention a key
      left out moves the logits only where it is a query's top key
      (:func:`ring_attention` catches it at unit spread).
    * bf16: wherever the forward's top-2 gap exceeds twice its bf16 error
      (|bf16 logit - f32 logit|), its argmax is the ring's token.  At random
      weights the near-uniform router lets bf16 rounding flip experts, the
      error is of the logits' own size and no position may qualify: the
      count is printed."""
    import dataclasses as dc

    from repro_torch.models import layers
    from repro_torch.models.api import Model
    from repro_torch.models.transformer import lm_forward

    dropless = dc.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    m = {dt: Model(dc.replace(cfg, moe=dropless, dtype=dt))
         for dt in (torch.bfloat16, torch.float32, torch.float64)}
    m16, m32, m64 = m.values()
    nl, dev = cfg.n_layers, eng.device
    ring_fn, caught = layers.ring_entries, {}

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    n_sure = agree = 0
    worst = worst32 = 0.0
    for i in RING_LANES:
        prompt, tier = prompts[i], i % 3
        n, pad = len(prompt) + MIX_NEW - 1, MIX_PREFILL - len(prompt)
        dense = _tier_tree(torch, eng.params, tier)
        seq = torch.zeros((1, FWD_LEN), dtype=torch.int32, device=dev)
        at = slice(len(prompt) - 1, len(prompt) - 1 + MIX_NEW)
        moved = []
        with torch.no_grad():
            _, out = _ring_logits(torch, m16, eng.params, prompt, tier, dev)
            seq[0, :n] = torch.tensor(prompt + out[:-1], dtype=torch.int32)
            with _f64_reference(torch):
                with _Recorder(torch) as r64:
                    ring64, _ = _ring_logits(torch, m64, dense, prompt, tier, dev, feed=out)
                route = _forced_route(torch, r64.rows("moe_route", nl, n, pad),
                                      r64.rows("weight", nl, n, pad), moved)
                with _Recorder(torch, route=route) as f64:
                    fwd64 = lm_forward(dense, m64.cfg, seq)[0, at]
            with _Recorder(torch) as r32:
                ring32, _ = _ring_logits(torch, m32, eng.params, prompt, tier, dev, feed=out)
            with _Recorder(torch) as f32:
                fwd32 = lm_forward(dense, m32.cfg, seq)[0, at]
            fwd16 = lm_forward(dense, m16.cfg, seq)[0, at]
        scale = float(fwd64.abs().max())
        if scale == 0:
            raise AssertionError(f"lane {i}: the forward's logits are all 0")
        d64 = rel(ring64, fwd64)
        worst, worst32 = max(worst, d64), max(worst32, rel(ring32, fwd32))
        layer_gaps = []
        for li in range(nl):
            gaps = []
            for rr, ff in ((r64, f64), (r32, f32)):
                ra = rr.rows("prefill_attention", nl, n, pad, steps="decode_attention")[li]
                gaps.append(rel(ra, ff.rows("attention", nl, n)[li]))
            diff = (r32.rows("moe_route", nl, n, pad)[li].sort(-1).values
                    != f32.rows("moe_route", nl, n)[li].sort(-1).values).any(-1)
            layer_gaps.append(f"L{li} attention {gaps[0]:.2e} (f64) {gaps[1]:.2e} (f32), "
                              f"{int(diff.sum())} tokens routed otherwise in f32")
        say(f"    lane {i} ({TIER_NAMES[tier]}, {len(prompt)} tokens, max |logit| "
            f"{scale:.3f}): |ring - forward| f64 {d64:.3e} (forced tokens {sum(moved)}); f32 "
            f"{rel(ring32, fwd32):.3e}, f32 forward vs f64 {rel(fwd32, fwd64):.3e}, f32 ring "
            f"vs f64 {rel(ring32, ring64):.3e}; " + "; ".join(layer_gaps))
        if d64 > RING_TOL:
            raise AssertionError(f"lane {i} ({TIER_NAMES[tier]}): f64 ring logits off the "
                                 f"windowed forward's by {d64:.3e} of the largest > {RING_TOL}")
        if i == RING_LANES[-1]:  # it evicts: what each planted ring fault moves
            for name, fault in (("drop_oldest", _drop_oldest), ("write_ahead", _write_ahead)):
                layers.ring_entries = fault(torch, ring_fn)
                try:
                    with torch.no_grad(), _f64_reference(torch):
                        bad, _ = _ring_logits(torch, m64, dense, prompt, tier, dev, feed=out)
                finally:
                    layers.ring_entries = ring_fn
                caught[name] = rel(bad, fwd64)
            if caught["write_ahead"] <= RING_TOL:
                raise AssertionError(f"lane {i}: a ring writing one slot ahead passes the "
                                     f"bound: {caught['write_ahead']:.3e} <= {RING_TOL}")
        err = (fwd16 - fwd32).abs().amax(-1)
        top = torch.topk(fwd16, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > 2 * err
        arg = fwd16.argmax(-1).cpu()
        bad = [j for j in range(MIX_NEW) if bool(sure[j]) and int(arg[j]) != out[j]]
        if bad:
            raise AssertionError(f"lane {i} ({TIER_NAMES[tier]}): the ring's tokens leave "
                                 f"the windowed forward's argmax at {bad}, top-2 gap above "
                                 f"twice the bf16 error")
        n_sure += int(sure.sum())
        agree += int((arg == torch.tensor(out)).sum())
        del dense, r64, f64, r32, f32
    say(f"  the model through the ring vs the windowed forward, lanes {list(RING_LANES)} "
        f"({MIX_PREFILL}-wide admission + {MIX_NEW - 1} decodes across the wrap; the forward "
        f"padded to {FWD_LEN}; capacity factor {dropless.capacity_factor:g}): logits max "
        f"|ring - forward| {worst:.3e} of the largest |logit| in f64 (tolerance {RING_TOL}), "
        f"{worst32:.3e} in f32 (printed); planted ring faults, lane {RING_LANES[-1]}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in caught.items()) + f" (write_ahead held); "
        f"bf16: "
        f"forward argmax == ring token at {agree} of {len(RING_LANES) * MIX_NEW} positions; "
        f"{n_sure} with a top-2 gap above twice the bf16 error"
        + (" (none: the rule checks nothing here)" if n_sure == 0 else ""))


def mixtral_full_width(torch, workdir: Path) -> dict:
    """mixtral-8x22b at its published widths cut to ``MIX_LAYERS`` layers
    (random weights from seed 0) through the main path: compress, save,
    load(verify=True), engine(quality="mid", max_prompt=4064); a mixed-tier
    stream of 3900-4064-token prompts and 64 new tokens each, eager and
    captured (the ring wraps at cache index 4096 in every lane's decode);
    replayed decode and admission logits equal eager; the ring against the
    windowed forward; speculation refused; the split of a decode step.
    Then the smoke config (window 32) gives the CPU's tokens on the card.
    Returns the captured stream's launches."""
    import gc

    from repro_torch import api
    from repro_torch.configs import get_arch

    gc.collect()  # [12]'s engines and graph pools
    torch.cuda.empty_cache()
    full = get_arch(MIX_ARCH)
    cfg = dataclasses.replace(full, n_layers=MIX_LAYERS)
    e_bytes = 3 * cfg.moe.n_experts * cfg.d_model * cfg.d_ff * 2 * cfg.n_layers
    say(f"  reduced: n_layers {full.n_layers} -> {cfg.n_layers}, nothing else (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.hd}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} of d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}, bf16); "
        f"dense bf16 experts {e_bytes / 1e9:.2f} GB, {e_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms a "
        f"decode step at the byte bound")
    torch.cuda.reset_peak_memory_stats()
    art, path, t_save, t_load = compress_saved(torch, workdir, cfg, MIX_ARCH)
    say(f"  artifact {path.stat().st_size / 2**30:.3f} GiB, compress+save {t_save:.1f} s, "
        f"load(verify) {t_load:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    path.unlink()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(max_prompt=MIX_PREFILL, max_len=MIX_PREFILL + MIX_NEW + 1)
    prompts = ring_prompts(torch, cfg)
    _, c, eng = eager_and_captured(torch, art, cfg, "mixtral-8x22b", prompts=prompts,
                                   max_new=MIX_NEW, **kw)
    say(f"  the ring: {eng._session.cache.kv.k.shape[2]} entries for a {kw['max_len']}-"
        f"position slot")
    graph_logits_equal(torch, eng, "mixtral-8x22b")
    profile_admission(torch, eng, prompts[11], "mid", label="mixtral-8x22b captured")
    try:
        eng.submit(prompts[0], max_new=4, speculate=api.SpecConfig("lo", k=2))
    except api.SubmitRejected as e:
        say(f"  speculation refused: {e}")
    else:
        raise AssertionError("mixtral-8x22b: a speculating request was admitted")
    eager = art.engine(quality="mid", batch_slots=8, device="cuda", eager=True, **kw)
    profile_moe_decode(torch, eager, eng, prompts[:8], label="mixtral-8x22b")
    say(f"  peak device memory while serving (two engines' dense experts): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    ring_attention(torch, eng, prompts, cfg)
    ring_vs_forward(torch, eng, prompts, cfg)
    say(f"  peak device memory over [13]'s serving: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eng, art
    gc.collect()
    torch.cuda.empty_cache()
    ring_card_vs_cpu(torch, workdir, get_arch(MIX_ARCH, smoke=True))
    return c["launches"]


def ring_card_vs_cpu(torch, workdir: Path, cfg) -> None:
    """The smoke config's ring (window 32) on the card (captured engine)
    against the CPU: identical greedy tokens in two sessions, one whose
    40-token prefill is wider than the ring (the last 32 tokens kept at
    slots i % 32) and one whose 16-token prefill fits and whose 60 new
    tokens wrap it; both run past 64 positions."""
    from repro_torch import api

    model, params = d64_model_params(torch, cfg)
    path = api.compress(model, params, device="cpu").save(workdir / "swa.edge.npz")
    art = api.load(path)
    quals = ["hi", "lo", "mid", "hi", "mid"]
    sessions = (((40, 7, 33, 21, 38), 40, 40), ((16, 5, 11, 9), 16, 60))
    toks = {}
    for dev in ("cpu", "cuda"):
        toks[dev] = []
        for lens, prefill, new in sessions:
            gen = torch.Generator().manual_seed(8 + prefill)
            prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist() for n in lens]
            eng = art.engine(quality="mid", batch_slots=4, max_prompt=prefill,
                             max_len=prefill + new + 1, device=dev)
            rids = [eng.submit(p, max_new=new, quality=q) for p, q in zip(prompts[:3], quals)]
            eng.step()
            rids += [eng.submit(p, max_new=new, quality=q)
                     for p, q in zip(prompts[3:], quals[3:])]
            eng.run_until_drained()
            if eng._session.cache.kv.k.shape[2] != cfg.window:
                raise AssertionError("the smoke ring is not window-long")
            toks[dev].append([eng.poll(r).tokens for r in rids])
            if dev == "cuda" and len(eng._session.graphs) == 0:
                raise AssertionError("the card engine captured no graph")
    if toks["cpu"] != toks["cuda"]:
        raise AssertionError(f"ring tokens differ between card and CPU:\n{toks}")
    n = sum(len(t) for sess in toks["cuda"] for t in sess)
    say(f"  {cfg.name}: {n} greedy tokens identical on card (captured) and CPU over two "
        f"sessions (prefill 40 > window 32, then 40 new; prefill 16, then 60 new: the ring "
        f"wraps in both, up to 80 and 76 positions)")
    path.unlink()


# --------------------------------------------------------------------------
# Phase 14: the recurrent families (mamba2-1.3b, the Jamba hybrid)
# --------------------------------------------------------------------------
SSM_ARCH = "mamba2_1_3b"
HYBRID_ARCH = "jamba_1_5_large_398b"
SSM_NEW = 32  # new tokens a prompt
SSM_FWD_LAYERS = 4  # of 48: the forward-vs-decode check, in f32
SSM_FWD_LEN = 320  # one full 256-token chunk and a padded partial one
# |forward - decode| over the largest |logit| (f32).  The cause of the gap:
# the forward's dual form takes each intra-chunk decay as exp(cs_i - cs_j),
# a difference of f32 cumulative sums that reach |cs| ~ 1e2 within a chunk,
# so a decay near the diagonal carries ~1e-5 of relative error, where the
# decode multiplies exact one-step decays; the projections' sums (K up to
# 4096) add ~1e-6.  Four layers at ~1e-5 each: bound 2e-4.
SSM_FWD_TOL = 2e-4
SSM_RANGES = ((("ssm", "W"), "W dense decode"),
              (("ssm", "_conv_ssd_step"), "conv + SSD recurrence"),
              (("ssm", "ssm_decode"), "projection matmuls + gated norm"))


def ssm_prompts(torch, cfg, seed=3):
    """8 prompts of 48 to 64 tokens."""
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (48 + (16 * i) // 7,), generator=rng).tolist()
            for i in range(8)]


def _static_timed(torch, eng, prompts, max_new):
    """One ``generate()`` with its scanned prefill and its decode loop timed
    apart (synchronized around each) -> (tokens, prefill ms, decode ms, s)."""
    box = {}

    def timed(name, fn):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            box[name] = (time.perf_counter() - t0) * 1e3
            return out
        return call

    prefill, loop = eng._prefill, eng._decode_loop
    eng._prefill, eng._decode_loop = timed("prefill", prefill), timed("decode", loop)
    try:
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng._prefill, eng._decode_loop = prefill, loop
    return toks, box["prefill"], box["decode"], wall


def _syncs_of_generate(torch, eng, prompts, max_new) -> tuple[list, int]:
    """``generate()`` under torch's sync debug mode -> (tokens, host syncs)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            toks = eng.generate(prompts, max_new=max_new)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return toks, sum("synchroniz" in str(w.message) for w in caught)


def k1_leaves(params, family):
    """The packed leaves a static decode position reads through K1 (mamba2:
    the head; the VLM: all but the cross blocks' wk/wv; whisper: the
    decoder's self wq/wk/wv, its cross wq and the head) and those W decodes
    to dense at every position (mamba2's mixers, whisper's decoder MLP)."""
    from repro_torch.quant.store import PackedWeight
    from repro_torch.tree import path_str, tree_leaves_with_path

    k1, w = [], []
    for path, leaf in tree_leaves_with_path(params, is_leaf=lambda x: isinstance(x, PackedWeight)):
        if not isinstance(leaf, PackedWeight):
            continue
        p = path_str(path)
        if family == "ssm":
            (k1 if p == "embed/head" else w).append(leaf)
        elif family == "vlm":
            if p not in ("cross_blocks/attn/wk", "cross_blocks/attn/wv"):
                k1.append(leaf)
        elif p == "embed/head" or p.startswith(("dec_blocks/self_attn/",
                                                 "dec_blocks/cross_attn/wq")):
            k1.append(leaf)
        elif p.startswith("dec_blocks/mlp/"):
            w.append(leaf)
    return k1, w


def static_step_traffic(torch, eng) -> dict:
    """What a decode position does with the packed weights: ``k1``, the bytes
    K1 reads (the planes the tier keeps and the scales); ``w``, a floor on
    the bytes W's dense decode of the other leaves (:func:`k1_leaves`) moves,
    the same at every tier: all three planes and the scales read, the dense
    f32 weight written and read back by the cast, the bf16 weight written
    and read by the matmul (unpack's own intermediates move more);
    ``meter``, the plane bytes the engine's meter charges (every packed
    leaf: what a packed kernel would read, the encoder's and the cross
    wk/wv that decode does not read included); ``nonzero``, the nonzero
    plane words the engine serves, counted on the card (a tier's
    truncation zeroes planes)."""
    from repro_torch.quant.store import PackedWeight
    from repro_torch.tree import tree_leaves

    k1, w = k1_leaves(eng.params, eng.model.cfg.family)
    leaves = [x for x in tree_leaves(eng.params, is_leaf=lambda x: isinstance(x, PackedWeight))
              if isinstance(x, PackedWeight)]
    return dict(
        k1=sum(x.planes.numel() * 4 * (3 - x.demand_drop(0)) // 3 + x.scales.numel() * 4
               for x in k1),
        w=sum(x.planes.numel() * 4 + x.scales.numel() * 4 + 12 * (x.planes.numel() // 3 * 32)
              for x in w),
        meter=4 * eng._forward_plane_words(0)[0],
        nonzero=sum(int(torch.count_nonzero(x.planes)) for x in leaves))


def k1_per_position(cfg) -> int:
    """K1 launches of one static decode position: mamba2's head; the VLM's 6
    packed matmuls a self layer, 4 a cross block (wq, the MLP) and the head;
    whisper's 4 a decoder layer (self wq/wk/wv, cross wq) and the head."""
    if cfg.family == "ssm":
        return 1
    if cfg.family == "vlm":
        return 6 * cfg.n_layers + 4 * (cfg.n_layers // cfg.cross_every) + 1
    return 4 * cfg.n_layers + 1


def static_serve(torch, art, cfg, prompts, max_new, label,
                 dev="cuda") -> tuple[dict, object, list]:
    """A family without the fused prefill at full width: single-tier
    engines at hi / mid / lo, each ``generate()`` a per-token scanned
    prefill and one decode loop (the cross families' over zero cross K/V).
    Gates: one host sync a generate; the
    same tokens on a second identical call; K1 launched
    :func:`k1_per_position` times a position and no other kernel, no plain
    version; the nonzero plane words served ordered hi > mid > lo.  Returns
    (the mid run's launches, the mid engine, its tokens)."""
    from repro_torch.kernels import dispatch, qsq, ref

    maxp = max(len(p) for p in prompts)
    want = k1_per_position(cfg) * (maxp + max_new)
    nonzero, launches = {}, {}
    for q in ("mid", "hi", "lo"):
        eng = art.engine(quality=q, batch_slots=8, device=dev)
        if eng.per_request_quality or eng.n_packed_leaves <= 0:
            raise AssertionError(f"{label} {q}: per_request_quality "
                                 f"{eng.per_request_quality}, {eng.n_packed_leaves} packed")
        traffic = static_step_traffic(torch, eng)
        nonzero[q] = traffic["nonzero"]
        first = None
        if q == "mid":
            eng.generate([[1, 2]], max_new=1)  # the first use of every code path
            first, syncs = _syncs_of_generate(torch, eng, prompts, max_new)
            if syncs != 1:
                raise AssertionError(f"{label} generate synced the host {syncs} times, not once")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qsq.reset_launches()
        ref.calls.clear()
        dispatch.reset_counters()
        toks, pre_ms, dec_ms, wall = _static_timed(torch, eng, prompts, max_new)
        launches[q] = dict(qsq.launches)
        counters = dict(dispatch.counters)
        if launches[q] != {"qsq_matvec": want} or counters.get("gemv") != want:
            raise AssertionError(f"{label} {q}: launches {launches[q]}, routes {counters}; "
                                 f"want K1 {want} times ({k1_per_position(cfg)} a position)")
        if sum(ref.calls.values()):
            raise AssertionError(f"plain versions ran on the card: {dict(ref.calls)}")
        if first is not None and toks != first:
            raise AssertionError(f"{label}: a second identical generate() gave other tokens")
        if not all(len(t) == max_new and all(0 <= v < cfg.vocab for v in t) for t in toks):
            raise AssertionError(f"{label}: malformed token lists")
        wbytes = (f"; W's dense decode moves at least {traffic['w']} B" if traffic["w"]
                  else "")
        say(f"  {label} {q}: generate {wall * 1e3:.1f} ms for 8 x {max_new} tokens "
            f"({8 * max_new / wall:.1f} tokens/s); scanned prefill {pre_ms / maxp:.2f} ms a "
            f"position ({maxp} positions), decode {dec_ms / max_new:.2f} ms a position; a "
            f"position (8 tokens) reads {traffic['k1']} B of planes and scales in K1{wbytes} "
            f"(the meter charges {traffic['meter']} B of planes); {nonzero[q]} nonzero plane "
            f"words served; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
            f"{launches[q]['qsq_matvec']}, routes {counters}, plain versions 0"
            + ("; the same tokens as a first identical call, which synced the host once"
               if first is not None else ""))
        if q == "mid":
            mid = (eng, toks)
    if not nonzero["hi"] > nonzero["mid"] > nonzero["lo"]:
        raise AssertionError(f"{label}: nonzero plane words not ordered hi > mid > lo: {nonzero}")
    return launches["mid"], mid[0], mid[1]


def static_profile_step(torch, eng, prompts, label, ranges, steps=2, dev="cuda"):
    """The device time of a static decode step (8 slots, after a 4-token
    prefill; a step's work does not depend on the position) split into K1
    and ``ranges``, ((module, function), kind) pairs (the innermost around
    each op), and the rest; launches a step and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import encdec, layers, ssm, transformer
    from repro_torch.models.base import init_params

    mods = {"layers": layers, "transformer": transformer, "encdec": encdec, "ssm": ssm}
    names = {fn: kind for (_, fn), kind in ranges}
    model, params = eng.model, eng.params
    toks = torch.tensor([p[:4] for p in prompts], dtype=torch.int32)
    cache = init_params(model.cache_descs(8, 4 + steps + 2), device=dev)
    cache, logits = model.prefill(params, cache, toks.to(dev))
    cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
    logits, cache = model.decode(params, cache, {"tokens": cur})  # warm
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for mod in {m for (m, _), _ in ranges}:
            stack.enter_context(_ranged(torch, mods[mod],
                                        [fn for (m, fn), _ in ranges if m == mod]))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode(params, cache, {"tokens": cur})
            cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kinds = ["K1"] + [kind for _, kind in ranges] + ["rest"]
    kern = [r for r in device_kernels(prof) if r[0] not in names]
    busy = sum(t for _, t, _ in kern)
    n_launch = sum(n for _, _, n in kern)
    split = dict.fromkeys(kinds, 0.0)
    split["K1"] = sum(t for key, t, _ in kern if kernel_of(key))
    for evt in prof.events():  # torch's kernels, by the innermost range of their op
        if evt.device_type != DeviceType.CPU:
            continue
        for k in evt.kernels:
            if not (kernel_of(k.name) or k.name in names):
                split[_category(evt, names)] += k.duration
    split["rest"] += busy - sum(split.values())
    parts = ", ".join(f"{k} {split[k] / steps / 1e3:.3f} ms "
                      f"({100 * split[k] / max(busy, 1e-9):.1f}%)" for k in kinds)
    say(f"  {label} mid decode step (8 slots, profiled, eager): wall {wall:.2f} ms, device "
        f"busy {busy / steps / 1e3:.3f} ms ({100 * busy / steps / 1e3 / wall:.1f}% of wall), "
        f"{n_launch // steps} launches; {parts}")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:6]:
        say(f"    {t / steps / 1e3:7.3f} ms/step  {n // steps:5d} launches/step  {name[:90]}")
    k1, _ = k1_leaves(params, model.cfg.family)
    kb = sum(x.planes.numel() * 4 * (3 - x.demand_drop(0)) // 3 + x.scales.numel() * 4
             for x in k1)
    say(f"  K1 a step: {kb / 1e6:.1f} MB of planes and scales, bound "
        f"{kb / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s; measured "
        f"{split['K1'] / steps / 1e3:.4f} ms")


def _spread_mixers(torch, params, seed=5):
    """Conv taps of std 0.3, decay logs and dt biases uniform in [-1, 0.5),
    in place: at the descriptors' init (taps of std 0.02) the SSD's share
    of the output is ~1e-3 of the skip path's, too small for the check."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mixer = params["blocks"]["mixer"]
    for name in ("conv_x", "conv_B", "conv_C"):
        t = mixer[name]
        t.copy_(0.3 * torch.randn(t.shape, generator=gen, device="cuda", dtype=torch.float32))
    for name in ("a_log", "dt_bias"):
        t = mixer[name]
        t.copy_(torch.rand(t.shape, generator=gen, device="cuda") * 1.5 - 1.0)


def ssm_forward_vs_decode(torch, full) -> int:
    """mamba2 at its published widths cut to ``SSM_FWD_LAYERS`` layers, f32,
    served packed from an artifact: ``Model.forward`` on 2 x 320 tokens (its
    head through K3 at M = 640) against 320 step-by-step ``Model.decode``
    calls (K1 at M = 2), within ``SSM_FWD_TOL`` of the largest |logit|; a
    planted fault (the forward forgets the state at the chunk boundary) must
    exceed it.  Returns K3's launches in the forward."""
    from repro_torch import api
    from repro_torch.kernels import qsq, ref
    from repro_torch.models import ssm
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params

    cfg = dataclasses.replace(full, n_layers=SSM_FWD_LAYERS, dtype=torch.float32)
    model = Model(cfg)
    params = init_params(model.param_descs(), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    _spread_mixers(torch, params)
    tp, _ = api.compress(model, params, device="cuda").serve_params("hi", device="cuda")
    del params
    toks = torch.randint(0, cfg.vocab, (2, SSM_FWD_LEN),
                         generator=torch.Generator().manual_seed(6)).to(torch.int32).cuda()
    qsq.reset_launches()
    ref.calls.clear()
    with torch.no_grad():
        fwd = model.forward(tp, {"tokens": toks})
        k3 = qsq.launches.get("qsq_matmul", 0)
        cache = init_params(model.cache_descs(2, SSM_FWD_LEN), device="cuda")
        rows = []
        for t in range(SSM_FWD_LEN):
            lg, cache = model.decode(tp, cache, {"tokens": toks[:, t:t + 1]})
            rows.append(lg[:, 0])
        dec = torch.stack(rows, 1)
        orig = ssm.ssd_chunked

        def forgetful(x, dt, a, bm, cm, chunk, h0=None):
            ys = [orig(x[:, i:i + chunk], dt[:, i:i + chunk], a, bm[:, i:i + chunk],
                       cm[:, i:i + chunk], chunk)[0] for i in range(0, x.shape[1], chunk)]
            return torch.cat(ys, 1), None

        ssm.ssd_chunked = forgetful
        try:
            bad = model.forward(tp, {"tokens": toks})
        finally:
            ssm.ssd_chunked = orig
    if not k3 or sum(ref.calls.values()) or not qsq.launches.get("qsq_matvec"):
        raise AssertionError(f"forward/decode launches {dict(qsq.launches)} (K3 in the "
                             f"forward {k3}), plain versions {dict(ref.calls)}")
    if not bool(torch.isfinite(fwd).all()) or fwd.shape != (2, SSM_FWD_LEN, cfg.vocab):
        raise AssertionError(f"forward logits malformed: {tuple(fwd.shape)}")
    scale = float(fwd.abs().max())
    gap = (fwd - dec).abs().amax(dim=(0, 2)) / scale  # by position
    fault = float((bad - dec).abs().max()) / scale
    say(f"  mamba2-1.3b at {SSM_FWD_LAYERS} layers, f32, {SSM_FWD_LEN} tokens x 2: forward (K3, "
        f"{k3} launches) vs {SSM_FWD_LEN} decode steps (K1): max |diff| / max |logit| "
        f"{float(gap.max()):.3e} (first chunk {float(gap[:cfg.ssm_chunk].max()):.3e}, from "
        f"the second on {float(gap[cfg.ssm_chunk:].max()):.3e}; bound {SSM_FWD_TOL:g}, largest "
        f"|logit| {scale:.3f}); planted fault (state dropped at the chunk boundary) {fault:.3e}")
    if float(gap.max()) > SSM_FWD_TOL:
        raise AssertionError(f"mamba2 forward off the decode by {float(gap.max()):.3e} of the "
                             f"largest |logit| > {SSM_FWD_TOL}")
    if fault <= 10 * SSM_FWD_TOL:
        raise AssertionError(f"the planted chunk-boundary fault moves the logits only "
                             f"{fault:.3e}: the check cannot see it")
    return k3


def recurrent_full_width(torch, workdir: Path) -> dict:
    """mamba2-1.3b at its published widths and depth (random weights from
    seed 0, bf16): compress, save, load(verify), served at three tiers
    (:func:`static_serve`), a decode step's device split; the forward against
    the decode at 4 layers; the smoke configs of both recurrent families,
    card against CPU.  Returns the mid serving run's launches and the
    forward check's."""
    import gc

    from repro_torch.configs import get_arch

    gc.collect()  # [13]'s engines
    torch.cuda.empty_cache()
    cfg = get_arch(SSM_ARCH)
    hyb = get_arch(HYBRID_ARCH)
    e_bytes = 4 * 3 * hyb.moe.n_experts * hyb.d_model * hyb.d_ff * 2  # 4 MoE layers a block
    say(f"  jamba-1.5-large-398b stays at its smoke config on the card: one 8-layer block "
        f"holds 4 MoE layers of {hyb.moe.n_experts} dense bf16 experts (3 x {hyb.d_model} x "
        f"{hyb.d_ff}), {e_bytes / 1e9:.1f} GB before anything else")
    torch.cuda.reset_peak_memory_stats()
    art, path, t_save, t_load = compress_saved(torch, workdir, cfg, SSM_ARCH)
    say(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, state "
        f"{cfg.ssm_state}, head dim {cfg.ssm_head_dim}, {str(cfg.dtype)[6:]}; artifact "
        f"{path.stat().st_size / 2**30:.3f} GiB, compress+save {t_save:.1f} s, load(verify) "
        f"{t_load:.1f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    path.unlink()
    t0 = time.perf_counter()
    prompts = ssm_prompts(torch, cfg)
    launches, eng, _ = static_serve(torch, art, cfg, prompts, SSM_NEW, cfg.name)
    static_profile_step(torch, eng, prompts, cfg.name, SSM_RANGES)
    del art, eng
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    k3 = ssm_forward_vs_decode(torch, cfg)
    t2 = time.perf_counter()
    static_card_vs_cpu(torch, workdir, (SSM_ARCH, HYBRID_ARCH))
    say(f"  [14] serving and profile {t1 - t0:.1f} s, forward vs decode {t2 - t1:.1f} s, smoke "
        f"configs card vs CPU {time.perf_counter() - t2:.1f} s")
    return launches, {"qsq_matmul": k3}


# --------------------------------------------------------------------------
# Phase 15: the cross-attending families (llama-3.2-vision-11b, whisper-tiny)
# --------------------------------------------------------------------------
VLM_ARCH = "llama_3_2_vision_11b"
WHISPER_ARCH = "whisper_tiny"
VLM_LAYERS = 10  # of 40: two groups of 5 self layers, each closed by its cross block
VLM_FWD_LAYERS = 5  # the forward-vs-decode check, f32: one group and its cross block
VLM_NEW, WHISPER_NEW = 16, 64  # new tokens a prompt
CROSS_FWD_LEN = 64  # teacher-forced tokens of the forward-vs-decode check
# |forward - decode| over the largest |logit| in f64 (the logits end f32); a
# planted fault (the first cross block's K/V zeroed) must exceed CROSS_FAULT.
# In f32 the two differ by ~1e-2 at random weights (cross_forward_vs_decode)
CROSS_FWD_TOL, CROSS_FAULT = 1e-6, 1e-2
# (K, N) of llama-3.2-vision-11b's packed leaves: wq, wk/wv, wg/wu, wd, head
VISION_SHAPES = {"llama-3.2-vision-11b": [(4096, 4096), (4096, 1024), (4096, 14336),
                                          (14336, 4096), (4096, 128256)]}
# (K, N) of whisper-tiny's kernel-served leaves: wq/wk/wv, head (N odd)
WHISPER_SHAPES = {"whisper-tiny": [(384, 384), (384, 51865)]}
# (shapes, M) where K3 fills cross K/V: the vision tokens' wk/wv (8 x 1024
# rows), the encoder's wq/wk/wv and the decoder's cross wk/wv (8 x 1500 rows)
CROSS_K3 = (([(4096, 1024)], 8 * 1024), ([(384, 384)], 8 * 1500))
VLM_RANGES = ((("layers", "decode_attention"), "self-attention"),
              (("layers", "cross_attention"), "cross attention"),
              (("transformer", "_cross_block_fwd"), "cross gates and MLP"))
WHISPER_RANGES = ((("layers", "decode_attention"), "self-attention"),
                  (("layers", "cross_attention"), "cross attention"),
                  (("encdec", "_gelu_mlp"), "GELU MLP"),
                  (("layers", "W"), "W dense decode"))


def cross_k3(torch, gen, flush) -> dict:
    """K3 at the rows that fill cross K/V (:data:`CROSS_K3`): within the f32
    bound at every demand, bf16 and f32 x; cold single calls (bf16 x)
    against ``torch.matmul`` and the byte bound."""
    out = {}
    for shapes, m in CROSS_K3:
        n = check_kernels(torch, gen, cases=[("qsq_matmul", m)], shapes=shapes)
        k, nn = shapes[0]
        b_s, o_s, ms, _, lib_ms = time_one(torch, gen, flush, "qsq_matmul", False, m, k, nn, 0,
                                           plain_too=False, runs=10)
        bound = max(b_s, o_s) * 1e3
        out[m] = dict(ms=ms, library_ms=lib_ms, bound_ms=bound)
        say(f"  K3 at M={m} K={k} N={nn}: {n} checks passed (f32 bound, every demand, bf16 "
            f"and f32 x); kernel {ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({'bytes' if b_s >= o_s else 'ops'}; {bound / ms:.1%} of bound)")
    return out


def spread_gates(torch, params, seed=5):
    """The VLM's cross gates, zero at init (tanh 0 = 0 makes a cross block
    the identity), drawn in place from +-[0.5, 1.5] (|tanh| 0.46-0.91)."""
    if "cross_blocks" not in params:
        return
    cb = params["cross_blocks"]
    gen = torch.Generator(device=cb["gate"].device).manual_seed(seed)
    for name in ("gate", "gate_mlp"):
        t = cb[name]
        mag = torch.rand(t.shape, generator=gen, device=t.device) + 0.5
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device) * 2 - 1
        t.copy_(mag * sign)


def cross_prompts(torch, cfg, lo, hi, seed=7):
    """8 prompts of ``lo`` to ``hi`` tokens."""
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (lo + ((hi - lo) * i) // 7,), generator=rng).tolist()
            for i in range(8)]


def side_input(torch, cfg, b, dev, seed=8):
    """The cross path's seeded input: vision embeddings (B, 1024, d) of std
    0.1, or encoder frames (B, enc_seq, d) of std 1, in ``cfg.dtype``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "vlm":
        return 0.1 * torch.randn((b, cfg.vision_tokens, cfg.d_model), generator=gen,
                                 device=dev).to(cfg.dtype)
    return torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)


def filled_cache(torch, model, params, side, b, t, dev):
    """A zero decode cache of (b, t) with the cross K/V of ``side`` filled
    (``vision_prefill_cross_kv`` / ``encdec_prefill_cross``: K3)."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.base import init_params

    cache = init_params(model.cache_descs(b, t), device=dev)
    if model.cfg.family == "vlm":
        return cache._replace(cross_kv=transformer.vision_prefill_cross_kv(params, model.cfg,
                                                                            side))
    ck, cv = encdec.encdec_prefill_cross(params, model.cfg, side)
    return cache._replace(cross_k=ck, cross_v=cv)


def cross_filled(torch, eng, prompts, max_new, zero_toks, label, dev="cuda") -> dict:
    """The filled path on the mid engine: the cross K/V of a seeded side
    input through K3 (the VLM: 2 x (wk, wv) at M = 8 x 1024; whisper: the
    encoder's 4 x (wq, wk, wv) and the decoder's 4 x (wk, wv) at M = 8 x
    1500), then ``Model.prefill`` and a greedy decode loop over that cache.
    A sanity check only: the tokens must differ from the zero-K/V run's.
    Returns K3's launches."""
    from repro_torch.kernels import qsq, ref
    from repro_torch.train.step import make_decode_loop

    model, params, cfg = eng.model, eng.params, eng.model.cfg
    maxp = max(len(p) for p in prompts)
    toks = torch.zeros((8, maxp), dtype=torch.int32)
    lens = torch.zeros((8,), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, maxp - len(p):] = torch.tensor(p)
        lens[i] = len(p)
    side = side_input(torch, cfg, 8, dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        qsq.reset_launches()
        ref.calls.clear()
        t0 = time.perf_counter()
        cache = filled_cache(torch, model, params, side, 8, maxp + max_new + 1, dev)
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        k3 = dict(qsq.launches)
        cache, logits = model.prefill(params, cache, toks.to(dev), lens.to(dev))
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out, _ = make_decode_loop(model)(params, cache, first, max_new)
        out = out.cpu().numpy()
    got = [out[:, i].tolist() for i in range(8)]
    want_k3 = 4 if cfg.family == "vlm" else 3 * cfg.enc_layers + 2 * cfg.n_layers
    if k3 != {"qsq_matmul": want_k3} or sum(ref.calls.values()):
        raise AssertionError(f"{label}: filling the cross K/V launched {k3} (want K3 "
                             f"{want_k3} times), plain versions {dict(ref.calls)}")
    differ = sum(a != b for a, b in zip(got, zero_toks, strict=True))
    if not differ:
        raise AssertionError(f"{label}: filled cross K/V gave the zero-K/V run's tokens")
    say(f"  {label} mid, filled path (a sanity check, not a parity check): cross K/V of "
        f"{tuple(side.shape)} filled through K3 in {fill_ms:.1f} ms ({k3['qsq_matmul']} "
        f"launches at M = {side.shape[0] * side.shape[1]}), then prefill and {max_new} "
        f"decode steps; {differ} of 8 token lists differ from the zero-K/V run's")
    return k3


@contextlib.contextmanager
def _one_sinusoid_source(torch, n):
    """While installed, the encoder-decoder's decode takes its position rows
    from the forward's numpy table (``layers.sinusoidal_pos_emb``) instead
    of computing them on the device (``encdec._sin_pos_at``): the two
    sources differ by an ulp of ``pow`` at some exponents, which the
    random-weight attention amplifies (:func:`cross_forward_vs_decode`)."""
    from repro_torch.models import encdec, layers

    orig = encdec._sin_pos_at

    def from_table(pos, d, dtype):
        table = torch.from_numpy(layers.sinusoidal_pos_emb(n, d)).to(pos.device)
        return table[pos.long()].to(dtype)

    encdec._sin_pos_at = from_table
    try:
        yield
    finally:
        encdec._sin_pos_at = orig


def _forward_and_decode(torch, model, params, toks, side, dev, fault=False):
    """``Model.forward`` over ``toks`` (B, n) with the side input, and n
    ``Model.decode`` steps over a cache with its cross K/V filled; with
    ``fault`` also the decode over the same cache with the first cross
    block's K/V zeroed -> (forward, decode, faulted decode or None)."""
    b, n = toks.shape
    key = "vision_embeds" if model.cfg.family == "vlm" else "frames"
    fwd = model.forward(params, {"tokens": toks, key: side})
    caches = [filled_cache(torch, model, params, side, b, n, dev)]
    if fault:
        good = caches[0]
        zeroed = {f: tuple(torch.cat([t[:1] * 0, t[1:]]) for t in getattr(good, f))
                  if f == "cross_kv" else torch.cat([getattr(good, f)[:1] * 0,
                                                      getattr(good, f)[1:]])
                  for f in good._fields if f != "kv"}
        caches.append(good._replace(kv=type(good.kv)(*(t.clone() for t in good.kv)), **zeroed))
    rows = [[] for _ in caches]
    for t in range(n):
        for r, c in zip(rows, caches, strict=True):
            r.append(model.decode(params, c, {"tokens": toks[:, t:t + 1]})[0][:, 0])
    out = [torch.stack(r, 1) for r in rows]
    return fwd, out[0], out[1] if fault else None


def cross_forward_vs_decode(torch, full, label, layers=None, dev="cuda") -> int:
    """The family at its published widths (the VLM cut to
    :data:`VLM_FWD_LAYERS` layers, depth only), cross gates spread, served
    packed from an f32 artifact: ``Model.forward`` over
    :data:`CROSS_FWD_LEN` teacher-forced tokens x 2 with a seeded side input
    against step-by-step ``Model.decode`` over the filled cache.
    * f64, on the served tier's decoded tree, the softmax and the norms in
      f64 on both sides (:func:`_f64_reference`), whisper's decode reading
      the forward's sinusoid table (:func:`_one_sinusoid_source`): within
      :data:`CROSS_FWD_TOL` of the largest |logit|; the first cross block's
      K/V zeroed must move the decode past :data:`CROSS_FAULT`.
    * f32 (printed, not held), the packed tree: the forward (K3) against
      the decode (K1), beside each one's distance from f64.  At random
      weights attention is nearly one-hot (the descriptors' fan-in of a
      (d, H, hd) projection is H, so scores spread over hundreds), and each
      position amplifies rounding: two f32 orders of one function differ by
      ~1e-2 of the largest |logit| after 64 positions.
    Returns K3's launches (forward and fill)."""
    from repro_torch import api
    from repro_torch.kernels import qsq, ref
    from repro_torch.models.api import Model
    from repro_torch.models.base import init_params
    from repro_torch.quant.store import dense_tree
    from repro_torch.tree import tree_map

    if layers is None:
        layers = VLM_FWD_LAYERS if full.family == "vlm" else full.n_layers
    cfg = dataclasses.replace(full, n_layers=layers, dtype=torch.float32)
    model, m64 = Model(cfg), Model(dataclasses.replace(cfg, dtype=torch.float64))
    params = init_params(model.param_descs(), torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    spread_gates(torch, params)
    tp, _ = api.compress(model, params, device=dev).serve_params("hi", device=dev)
    del params
    d64 = tree_map(lambda t: t.double(), dense_tree(tp, like=model.param_descs()))
    n = CROSS_FWD_LEN
    toks = torch.randint(0, cfg.vocab, (2, n),
                         generator=torch.Generator().manual_seed(6)).to(torch.int32).to(dev)
    side = side_input(torch, cfg, 2, dev, seed=9)
    qsq.reset_launches()
    ref.calls.clear()
    with torch.no_grad():
        fwd32, dec32, _ = _forward_and_decode(torch, model, tp, toks, side, dev)
        launches = dict(qsq.launches)
        with _f64_reference(torch), _one_sinusoid_source(torch, n):
            fwd64, dec64, bad64 = _forward_and_decode(torch, m64, d64, toks, side.double(), dev,
                                                      fault=True)
    del d64
    k3 = launches.get("qsq_matmul", 0)
    if not k3 or sum(ref.calls.values()) or not launches.get("qsq_matvec"):
        raise AssertionError(f"{label} forward/decode launches {launches}, plain versions "
                             f"{dict(ref.calls)}")
    if not bool(torch.isfinite(fwd32).all()) or fwd32.shape != (2, n, cfg.vocab):
        raise AssertionError(f"{label} forward logits malformed: {tuple(fwd32.shape)}")
    scale = float(fwd64.abs().max())

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / scale

    gap, planted = rel(fwd64, dec64), rel(bad64, dec64)
    say(f"  {label} at {cfg.n_layers} layers, {n} tokens x 2, largest |logit| {scale:.3f}: "
        f"f64 forward vs {n} decode steps over the filled cache {gap:.3e} of it (bound "
        f"{CROSS_FWD_TOL:g}); the first cross block's K/V zeroed {planted:.3e} (must exceed "
        f"{CROSS_FAULT:g}); f32 on the packed tree, printed: forward (K3) vs decode (K1) "
        f"{rel(fwd32, dec32):.3e}, the f32 forward's own distance from f64 "
        f"{rel(fwd32, fwd64):.3e}, the f32 decode's {rel(dec32, dec64):.3e}; launches "
        f"{launches}")
    if gap > CROSS_FWD_TOL:
        raise AssertionError(f"{label} f64 forward off the decode by {gap:.3e} of the largest "
                             f"|logit| > {CROSS_FWD_TOL}")
    if planted <= CROSS_FAULT:
        raise AssertionError(f"{label}: the planted cross K/V fault moves the logits only "
                             f"{planted:.3e}: the check cannot see it")
    return k3


def static_card_vs_cpu(torch, workdir: Path, archs) -> None:
    """The smoke configs of ``archs`` (f32, cross gates spread): one
    artifact, engines on the card and the CPU at hi / mid / lo, identical
    static greedy tokens (the cross families' over zero cross K/V); for the
    cross families also, on the hi tree, the filled path (cross K/V of one
    seeded side input, prefill, 12 decode steps) with identical tokens; the
    last prefill logits of every path within 1e-4 abs + 1e-4 rel."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.kernels import qsq
    from repro_torch.models.base import init_params
    from repro_torch.train.step import make_decode_loop

    for arch in archs:
        cfg = get_arch(arch, smoke=True)
        cross = cfg.family in ("vlm", "encdec")
        model, params = d64_model_params(torch, cfg)
        spread_gates(torch, params)
        path = api.compress(model, params, device="cpu").save(workdir / f"{arch}.edge.npz")
        art = api.load(path)
        gen = torch.Generator().manual_seed(9)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
                   for n in (7, 2, 12, 5)]
        toks = torch.zeros((4, 12), dtype=torch.int32)
        for i, p in enumerate(prompts):
            toks[i, 12 - len(p):] = torch.tensor(p)
        side = side_input(torch, cfg, 4, "cpu", seed=10) if cross else None
        out, last, filled = {}, {}, {}
        qsq.reset_launches()
        for dev in ("cpu", "cuda"):
            out[dev] = [art.engine(quality=q, batch_slots=4, device=dev).generate(
                prompts, max_new=12) for q in TIER_NAMES]
            tp, _ = art.serve_params("hi", device=dev)
            with torch.no_grad():
                cache = init_params(model.cache_descs(4, 26), device=dev)
                last[dev] = model.prefill(tp, cache, toks.to(dev))[1].cpu()
                if cross:
                    cache = filled_cache(torch, model, tp, side.to(dev), 4, 26, dev)
                    cache, lg = model.prefill(tp, cache, toks.to(dev))
                    first = torch.argmax(lg, -1).to(torch.int32)[:, None]
                    filled[dev] = make_decode_loop(model)(tp, cache, first, 12)[0].cpu().tolist()
                    last[dev] = torch.cat([last[dev], lg.cpu()])
        if out["cpu"] != out["cuda"] or filled.get("cpu") != filled.get("cuda"):
            raise AssertionError(f"{cfg.name}: card tokens differ from the CPU's:\n{out}\n"
                                 f"{filled}")
        if not qsq.launches.get("qsq_matvec") or (cross and not qsq.launches.get("qsq_matmul")):
            raise AssertionError(f"{cfg.name}: K1{'/K3' if cross else ''} did not launch on "
                                 f"the card: {dict(qsq.launches)}")
        diff = (last["cuda"] - last["cpu"]).abs()
        if not bool((diff <= 1e-4 + 1e-4 * last["cpu"].abs()).all()):
            raise AssertionError(f"{cfg.name}: prefill logits off the CPU's by "
                                 f"{float(diff.max()):.3e}")
        say(f"  {cfg.name}: {sum(len(t) for q in out['cuda'] for t in q)} static greedy tokens "
            + ("(zero cross K/V) and 48 filled-path tokens " if cross else "")
            + f"identical on card and CPU at hi / mid / lo; last prefill logits max |diff| "
            f"{float(diff.max()):.3e} (tolerance 1e-4 abs + 1e-4 rel); launches "
            f"{dict(qsq.launches)}")
        path.unlink()


def cross_full_width(torch, workdir: Path) -> dict:
    """llama-3.2-vision-11b at its published widths cut to
    :data:`VLM_LAYERS` layers and whisper-tiny at its published config
    (random weights from seed 0, bf16, cross gates spread): compress, save,
    load(verify), served at three tiers (:func:`static_serve`), the filled
    path, a decode step's device split; the forward against the decode in
    f32; the smoke configs card against CPU.  Returns, for each family, the
    launches of the mid generate (K1) and its filled path (K3), and K3's in
    the forward check."""
    import gc

    from repro_torch.configs import get_arch

    gc.collect()  # [14]'s engines
    torch.cuda.empty_cache()
    out = {}
    for arch, n_layers, lens, max_new, ranges in (
            (VLM_ARCH, VLM_LAYERS, (32, 64), VLM_NEW, VLM_RANGES),
            (WHISPER_ARCH, None, (4, 16), WHISPER_NEW, WHISPER_RANGES)):
        full = get_arch(arch)
        cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
        label = cfg.name + (f" ({cfg.n_layers} layers)" if n_layers else "")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        art, path, t_save, t_load = compress_saved(
            torch, workdir, cfg, arch, prepare=lambda p: spread_gates(torch, p))
        say(f"  {label}: d {cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv} KV), d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, {str(cfg.dtype)[6:]}; artifact "
            f"{path.stat().st_size / 2**30:.3f} GiB, compress+save {t_save:.1f} s, "
            f"load(verify) {t_load:.1f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        path.unlink()
        prompts = cross_prompts(torch, cfg, *lens)
        launches, eng, toks = static_serve(torch, art, cfg, prompts, max_new, label)
        launches.update(cross_filled(torch, eng, prompts, max_new, toks, label))
        static_profile_step(torch, eng, prompts, label, ranges)
        del art, eng
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out[arch] = (launches, cross_forward_vs_decode(torch, full, label))
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  [15] {label}: serving, filled path and profile {t1 - t0:.1f} s, forward vs "
            f"decode {time.perf_counter() - t1:.1f} s")
    t0 = time.perf_counter()
    static_card_vs_cpu(torch, workdir, (VLM_ARCH, WHISPER_ARCH))
    say(f"  [15] smoke configs card vs CPU {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# Phase 16: the dry run held against the card
# --------------------------------------------------------------------------
DRY_ARCH = "smollm_135m"
# (shape, probe depth, packed, gradient compression) of the cells [16] runs for real
DRY_CELLS = [("decode_32k", 1, False, False), ("decode_32k", 2, False, False),
             ("decode_32k", 1, True, False), ("decode_32k", 2, True, False),
             ("train_check", 1, False, True)]
PEAK_TOL = 0.10  # measured peak against the traced peak_bytes


def _real_leaves(torch, tree) -> list:
    """Every tensor of a real argument tree, into its packed leaves' planes and scales."""
    from repro_torch.quant.store import is_store
    from repro_torch.tree import tree_leaves

    out = []
    for leaf in tree_leaves(tree, is_leaf=is_store):
        out.extend((leaf.planes, leaf.scales) if is_store(leaf) else
                   [leaf] if isinstance(leaf, torch.Tensor) else [])
    return out


def dryrun_vs_card(torch) -> dict:
    """Phase 16 (a): each of :data:`DRY_CELLS` dry-run on the one-card mesh
    (``launch/dryrun.py``, meta tensors), then the same step run on the
    card from the same descriptors made real with ``init_params`` (seed 0):
    its FlopCounterMode total plus the kernels' 2 M K N equals the meta
    count, its dispatch counters and plane traffic equal the trace's, its
    arguments' bytes equal ``argument_bytes``, and its peak above the bytes
    held before the arguments were made is within :data:`PEAK_TOL` of
    ``peak_bytes``.  The packed decode must launch K3 (M = 128), the
    compressed train step K5, and no plain version may run.  Returns the
    launches of the five runs."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import dispatch, qsq, ref
    from repro_torch.launch import dryrun
    from repro_torch.models.base import init_params
    from repro_torch.optim import GradCompressionConfig

    full = get_arch(DRY_ARCH)
    shapes = {"decode_32k": "decode_32k", "train_check": ShapeConfig("train_check", 1024, 8,
                                                                      "train")}
    total: dict = {}
    for shape, depth, packed, compressed in DRY_CELLS:
        cfg = dryrun.probe_config(full, depth)
        cc = GradCompressionConfig(enabled=True) if compressed else None
        label = (f"{shape}, {depth} layer{'s' if depth > 1 else ''}"
                 f"{', packed' if packed else ''}{', compressed' if compressed else ''}")
        t0 = time.perf_counter()
        kw = dict(cfg_override=cfg, packed=packed, cc=cc)
        meta = dryrun.run_cell(DRY_ARCH, shapes[shape], save=False, probes_enabled=False, **kw)
        t_meta = time.perf_counter() - t0
        cell = dryrun.build_cell(DRY_ARCH, shapes[shape], **kw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device="cuda").manual_seed(0)
        args = [init_params(d, gen, device="cuda") for d in cell.descs]
        torch.cuda.synchronize()
        arg_bytes = sum(t.nbytes for t in _real_leaves(torch, args))
        held = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counters()
        qsq.reset_launches()
        ref.calls.clear()
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = cell.step(*args)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - base
        flops = fc.get_total_flops() + qsq.work["flops"]
        launches = dict(+qsq.launches)
        counts = {"counters": dict(+dispatch.counters), "traffic": dict(+dispatch.traffic)}
        del out, args
        pd = meta["per_device"]
        gap = (peak - pd["peak_bytes"]) / pd["peak_bytes"]
        say(f"  {label}: flops card {flops:,} meta {pd['flops']:,.0f}; arguments "
            f"{arg_bytes:,} B (allocated {held:,}), meta {pd['argument_bytes']:,}; peak card "
            f"{peak:,} B, meta {pd['peak_bytes']:,} B (temp {pd['temp_bytes']:,}), gap "
            f"{gap:+.4%}; bytes accessed {pd['bytes_accessed']:,.0f}, roofline "
            f"{meta['roofline']['bound_s'] * 1e3:.3f} ms ({meta['roofline']['dominant']}); "
            f"launches {launches}; dispatch {counts['counters']}; meta {t_meta:.1f} s, "
            f"step {t_step * 1e3:.1f} ms")
        bad = []
        if float(flops) != pd["flops"]:
            bad.append(f"flops {flops} != meta {pd['flops']}")
        if counts != meta["dispatch"]:
            bad.append(f"dispatch {counts} != meta {meta['dispatch']}")
        if arg_bytes != pd["argument_bytes"]:
            bad.append(f"argument bytes {arg_bytes} != meta {pd['argument_bytes']}")
        if abs(gap) > PEAK_TOL:
            bad.append(f"peak {peak} off the traced {pd['peak_bytes']} by {gap:+.2%}")
        want = {"qsq_matmul"} if packed else {"qsq_quantize"} if compressed else set()
        if set(launches) != want or +ref.calls:
            bad.append(f"launches {launches} (want {sorted(want)}), plain versions "
                       f"{dict(ref.calls)}")
        if bad:
            raise AssertionError(f"[16] {label}: " + "; ".join(bad))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def dryrun_full_depth() -> None:
    """Phase 16 (b): smollm-135m at its 30 layers dry-run at the four shapes
    on the one-card mesh, on the host only: peak GB a device against the
    card's 80 GB, the dominant roofline term, ``useful_flops_ratio``."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    for shape in SHAPES:
        t0 = time.perf_counter()
        r = dryrun.run_cell(DRY_ARCH, shape, save=False, probes_enabled=False)
        if not r["supported"]:
            say(f"  {shape}: not supported ({r['skip_reason']})")
            continue
        pd, rt = r["per_device"], r["roofline"]
        say(f"  {shape}: peak {pd['peak_bytes'] / 1e9:.3f} GB a device "
            f"({'fits' if pd['peak_bytes'] <= 80e9 else 'does not fit'} 80 GB; arguments "
            f"{pd['argument_bytes'] / 1e9:.3f} GB), flops {pd['flops']:.4e}, bytes "
            f"{pd['bytes_accessed']:.4e}, dominant {rt['dominant']} "
            f"({rt['bound_s'] * 1e3:.3f} ms), useful_flops_ratio "
            f"{r['useful_flops_ratio']:.4f}; traced in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# Phase 17: the port's qsqlint, its capture contexts against the card
# --------------------------------------------------------------------------
LINT_ENGINE = "src/repro_torch/serve/engine.py"
LINT_STEP = "src/repro_torch/train/step.py"
RUN_CLOSURES = {(LINT_ENGINE, "ServeEngine._decode_call.<lambda>"),
                (LINT_ENGINE, "ServeEngine._admit_call.<lambda>"),
                (LINT_ENGINE, "ServeEngine._verify_call.verify")}
# a captured step that reads a device value on the host; {src} is the port's path
PLANTED_CHILD = """\
import sys

import torch

sys.path.insert(0, {src!r})
from repro_torch.serve.graphs import StepGraphs  # noqa: E402

buf = torch.arange(4, dtype=torch.float32, device="cuda")


def step():
    scale = buf.sum().item()  # planted host sync
    return buf * scale


StepGraphs(torch.device("cuda")).run(("planted",), step)
print("captured")
"""


def _recorded_graph(torch, entered: set):
    """``torch.cuda.graph`` recording, with ``sys.setprofile``, the port's
    functions entered inside its block into ``entered``."""
    from repro_torch.analysis import entered_functions

    class Recorded(torch.cuda.graph):
        def __enter__(self):
            out = super().__enter__()
            self._rec = entered_functions(ROOT)
            self._calls = self._rec.__enter__()
            return out

        def __exit__(self, *exc):
            self._rec.__exit__(*exc)
            entered.update(self._calls)
            return super().__exit__(*exc)

    return Recorded


def lint_and_captures(torch, workdir: Path) -> None:
    """Phase 17: (1) the port's files lint clean; (2) on a captured d64
    engine serving decode, admission and a speculative verify, the functions
    of ``serve/engine.py`` and ``train/step.py`` entered inside
    ``StepGraphs._capture``'s ``torch.cuda.graph`` block include the three
    run closures and are all among the linter's capture contexts; (3) a
    planted ``.item()`` in a captured step is flagged at its line and its
    capture fails on the card, in a child process."""
    import tempfile

    from repro_torch import api
    from repro_torch.analysis import capture_contexts, lint_paths
    from repro_torch.analysis.config import default_paths
    from repro_torch.analysis.linter import lint_report

    t0 = time.perf_counter()
    vs, report = lint_report(default_paths(ROOT), root=ROOT)
    t_lint = time.perf_counter() - t0
    if vs:
        raise AssertionError("[17] the port does not lint clean:\n"
                             + "\n".join(v.format() for v in vs))
    say(f"  lint: {report['files']} files, 0 violations, pragmas honoured by rule "
        f"{dict(sorted(report['pragmas'].items()))}, {t_lint:.2f} s")
    contexts = {(c["path"], c["qualname"])
                for c in capture_contexts(["src/repro_torch"], root=ROOT)}

    t1 = time.perf_counter()
    model, params = d64_model_params(torch)
    path = api.compress(model, params, device="cpu").save(workdir / "d64_lint.edge.npz")
    eng = api.load(path).engine(quality="hi", batch_slots=4, max_prompt=8, max_len=32,
                                device="cuda")
    entered: set = set()
    plain = torch.cuda.graph
    torch.cuda.graph = _recorded_graph(torch, entered)
    try:
        prompts = [[5, 9, 2], [17], [3, 3, 3, 3, 8, 1], [250, 1]]
        rids = [eng.submit(p, max_new=6, quality=q,
                           speculate=api.SpecConfig("lo", k=3) if i == 0 else None)
                for i, (p, q) in enumerate(zip(prompts, ["hi", "mid", "lo", "hi"], strict=True))]
        eng.run_until_drained()
    finally:
        torch.cuda.graph = plain
    path.unlink()
    if not all(eng.poll(r).tokens for r in rids):
        raise AssertionError("[17] a request emitted no token")
    keys = sorted(map(repr, eng._session.graphs.keys()))
    if {k[0] for k in eng._session.graphs.keys()} != {"decode", "admit", "verify"}:
        raise AssertionError(f"[17] captured keys {keys}: decode, admit and verify expected")
    ours = {e for e in entered if e[0] in (LINT_ENGINE, LINT_STEP)}
    say(f"  captured {keys}; entered under capture in engine.py/step.py: "
        f"{sorted(q for _, q in ours)}")
    say(f"  the linter's capture contexts ({len(contexts)}): {sorted(q for _, q in contexts)}")
    if not RUN_CLOSURES <= ours:
        raise AssertionError(f"[17] run closures not entered under capture: "
                             f"{sorted(RUN_CLOSURES - ours)}")
    if not ours <= contexts:
        raise AssertionError(f"[17] entered under capture but no capture context: "
                             f"{sorted(ours - contexts)}")
    t_cap = time.perf_counter() - t1

    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        child = Path(tmp) / "planted_step.py"
        child.write_text(PLANTED_CHILD.format(src=str(ROOT / "src")))
        line = next(i for i, t in enumerate(child.read_text().splitlines(), 1)
                    if "planted host sync" in t)
        flagged = [v for v in lint_paths([child], root=tmp) if v.rule == "QSQ002"]
        if [v.line for v in flagged] != [line]:
            raise AssertionError(f"[17] QSQ002 flagged {[v.format() for v in flagged]}, "
                                 f"want line {line}")
        run = subprocess.run([sys.executable, str(child)], capture_output=True, text=True,
                             timeout=300)
    # the exceptions the child raised: the capture's, and only the capture's
    errors = [ln for ln in run.stderr.splitlines()
              if re.match(r"[A-Za-z_][\w.]*(Error|Exception): ", ln)]
    if (run.returncode == 0 or "captured" in run.stdout or not errors
            or not all("captur" in e for e in errors) or "buf.sum().item()" not in run.stderr):
        raise AssertionError(f"[17] the planted child should fail its capture at the "
                             f"planted line: exit {run.returncode}\n{run.stdout}\n{run.stderr}")
    say(f"  planted child: QSQ002 at line {line}; its capture failed on the card, exit "
        f"{run.returncode}: {' / '.join(errors)}")
    say(f"  [17] lint {t_lint:.2f} s, captures {t_cap:.1f} s, planted child "
        f"{time.perf_counter() - t2:.1f} s")


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
    say("[2] K1-K4 on the Table II layout (sign_mag=False, plane_major=False), demand 0")
    n = check_kernels(torch, gen, sign_mag=False, plane_major=False)
    say(f"    {n} checks passed: f32 bound, masked == truncated bit for bit (every variant)")
    table2 = time_kernels(torch, gen, flush, sign_mag=False, plane_major=False)
    say("[2] K1-K4 at the packed shapes of phi4-mini-3.8b, qwen3-14b and deepseek-7b")
    dense = dense_shapes(torch, gen, flush)
    say("[2] K1-K4 at the packed shapes of qwen3-moe-30b-a3b")
    moe_shapes = dense_shapes(torch, gen, flush, MOE_SHAPES)
    say("[2] K1-K4 at the packed shapes of mixtral-8x22b")
    mix_shapes = dense_shapes(torch, gen, flush, MIXTRAL_SHAPES)
    say("[2] K1-K4 at the packed shape of mamba2-1.3b; K1 and K3 at [14]'s rows")
    mamba_shapes = dense_shapes(torch, gen, flush, MAMBA2_SHAPES)
    n = check_kernels(torch, gen, cases=MAMBA2_CASES, shapes=MAMBA2_SHAPES["mamba2-1.3b"])
    say(f"  {n} checks at {MAMBA2_CASES} passed: f32 bound at every demand, bf16 and f32 x")
    say("[2] K1-K4 at the packed shapes of llama-3.2-vision-11b")
    vision_shapes = dense_shapes(torch, gen, flush, VISION_SHAPES)
    say("[2] K1-K4 at the packed shapes of whisper-tiny (the head's N odd)")
    whisper_shapes = dense_shapes(torch, gen, flush, WHISPER_SHAPES)
    say("[2] K3 at the rows that fill cross K/V (M 8192 and 12000)")
    cross_m = cross_k3(torch, gen, flush)
    del flush

    workdir = ROOT / "build" / "smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    say("[3] full-width smollm-135m from a compressed, saved and reloaded EdgeArtifact")
    from repro_torch.configs import get_arch

    launches, art_path = serve_full_width(torch, workdir, get_arch("smollm_135m"))
    say("[4] card against CPU at the 2-layer d64 test config")
    card_vs_cpu(torch, workdir)

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
    say("[8] verify windows beyond 64 rows: full-width speculative streams at 16 and 40 "
        "slots")
    speculative_wide(torch, gen, art_path, get_arch("smollm_135m"))
    art_path.unlink()
    say("[8] card against CPU: speculative and static serving at the d64 test config")
    spec_card_vs_cpu(torch, workdir)
    say("[9] the paper's pipeline: LeNet and ConvNet4 trained, quantized and compressed on "
        "the card")
    paper_pipeline(torch, workdir)
    say("[10] full-width smollm-135m served from pack_params (Table II planes)")
    packed_launches, packed_errs = packed_path(torch, gen, get_arch("smollm_135m"))
    say("[11] full-width phi4-mini-3.8b, eager and captured; qwen3-14b and deepseek-7b at 2 "
        "layers; the three smoke configs, card against CPU")
    phi4_launches = phi4_full_width(torch, workdir)
    reduced_full_width(torch, workdir)
    say(f"[12] qwen3-moe-30b-a3b at its published widths ({MOE_LAYERS} layers), eager and "
        f"captured; the MoE smoke config, card against CPU")
    moe_launches = moe_full_width(torch, workdir)
    say(f"[13] mixtral-8x22b at its published widths ({MIX_LAYERS} layers) through the "
        f"sliding-window ring, eager and captured; the smoke config's ring, card against CPU")
    mix_launches = mixtral_full_width(torch, workdir)
    say("[14] the recurrent families: mamba2-1.3b at its published widths and depth through "
        "the static path at three tiers; the forward against the decode at 4 layers; the "
        "mamba2 and jamba smoke configs, card against CPU")
    ssm_launches, ssm_fwd_launches = recurrent_full_width(torch, workdir)
    say(f"[15] the cross-attending families: llama-3.2-vision-11b at its published widths "
        f"({VLM_LAYERS} layers) and whisper-tiny at its published config through the static "
        f"path at three tiers, the cross K/V filled through K3; the forward against the "
        f"decode in f32; the two smoke configs, card against CPU")
    cross = cross_full_width(torch, workdir)
    t16 = time.perf_counter()
    say(f"[16] the dry run (meta tensors, the one-card mesh) held against real steps on the "
        f"card: {DRY_ARCH} decode_32k at 1 and 2 layers, dense and packed, and a compressed "
        f"train step at 1 layer")
    dry_launches = dryrun_vs_card(torch)
    say(f"[16] {DRY_ARCH} at its {get_arch(DRY_ARCH).n_layers} layers dry-run at the four "
        f"shapes (host only)")
    dryrun_full_depth()
    say(f"  [16] {time.perf_counter() - t16:.1f} s")
    say("[17] qsqlint for the port: the tree lints clean, the capture contexts against "
        "what the card captures, a planted host sync flagged and refused by the capture")
    lint_and_captures(torch, workdir)

    for name, row in rows.items():
        row["launches"] = launches.get(name, 0)
        row["launches_spec_static"] = spec_launches.get(name, 0)
        row["max_abs_err"] = None
    errs = max_abs_errors(torch, gen)
    errs2 = max_abs_errors(torch, gen, sign_mag=False, plane_major=False)
    for name, e in errs.items():
        rows[name]["max_abs_err"] = e
        rows[name]["launches_packed_params"] = packed_launches.get(name, 0)
        rows[name]["launches_phi4_mini"] = phi4_launches.get(name, 0)
        rows[name]["launches_qwen3_moe"] = moe_launches.get(name, 0)
        rows[name]["launches_mixtral"] = mix_launches.get(name, 0)
        rows[name]["launches_mamba2"] = ssm_launches.get(name, 0)
        rows[name]["launches_mamba2_forward"] = ssm_fwd_launches.get(name, 0)
        for arch, key in ((VLM_ARCH, "llama_vision"), (WHISPER_ARCH, "whisper")):
            launches_15, k3_fwd = cross[arch]
            rows[name][f"launches_{key}"] = launches_15.get(name, 0)
            rows[name][f"launches_{key}_forward"] = k3_fwd if name == "qsq_matmul" else 0
        for key, sums in (("vision", vision_shapes), ("whisper", whisper_shapes)):
            rows[name].update({f"{key}_shapes_ms": sums[name]["ms"],
                               f"{key}_shapes_library_ms": sums[name]["library_ms"],
                               f"{key}_shapes_bound_ms": sums[name]["bound_ms"]})
        if name == "qsq_matmul":
            for m, r in cross_m.items():
                rows[name].update({f"m{m}_ms": r["ms"], f"m{m}_library_ms": r["library_ms"],
                                   f"m{m}_bound_ms": r["bound_ms"]})
        rows[name].update(mixtral_shapes_ms=mix_shapes[name]["ms"],
                          mixtral_shapes_library_ms=mix_shapes[name]["library_ms"],
                          mixtral_shapes_bound_ms=mix_shapes[name]["bound_ms"],
                          mamba2_shapes_ms=mamba_shapes[name]["ms"],
                          mamba2_shapes_library_ms=mamba_shapes[name]["library_ms"],
                          mamba2_shapes_bound_ms=mamba_shapes[name]["bound_ms"])
        rows[name].update(dense_shapes_ms=dense[name]["ms"],
                          dense_shapes_library_ms=dense[name]["library_ms"],
                          dense_shapes_bound_ms=dense[name]["bound_ms"],
                          moe_shapes_ms=moe_shapes[name]["ms"],
                          moe_shapes_library_ms=moe_shapes[name]["library_ms"],
                          moe_shapes_bound_ms=moe_shapes[name]["bound_ms"])
        rows[name]["packed_params_max_abs_err"] = packed_errs.get(name)
        rows[name]["launches_dryrun_check"] = dry_launches.get(name, 0)
        rows[name].update(table2_ms=table2[name]["ms"], table2_plain_ms=table2[name]["plain_ms"],
                          table2_library_ms=table2[name]["library_ms"],
                          table2_bound_ms=table2[name]["bound_ms"],
                          table2_max_abs_err=errs2[name])
        say(f"    {name}: max |kernel - plain| {e:.3e} (plane-major, sign-magnitude), "
            f"{errs2[name]:.3e} (Table II layout)")
    k5_row.update(launches=train_launches.get(K5[0], 0), max_abs_err=k5_err,
                  launches_dryrun_check=dry_launches.get(K5[0], 0))
    say(f"    total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [rows[k] for k in KERNELS] + [k5_row]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def max_abs_errors(torch, gen, sign_mag=True, plane_major=True) -> dict:
    """Max |kernel - plain| per kernel over the five shapes (bf16 x)."""
    from repro_torch.kernels import qsq, ref

    layout = dict(sign_mag=sign_mag, plane_major=plane_major)
    out = {}
    for name, (masked, m, _, _) in KERNELS.items():
        worst = 0.0
        for k, n in SHAPES:
            x, planes, scales, mask = operands(torch, m, k, n, gen, torch.bfloat16,
                                               plane_major=plane_major)
            kw = dict(group_size=GROUP, **layout)
            fn = getattr(qsq, name)
            got = fn(x, mask, planes, scales, **kw) if masked else fn(x, planes, scales, **kw)
            want = (ref.qsq_matmul_plane_mask_ref(x, mask, planes, scales, **kw) if masked
                    else ref.qsq_matmul_ref(x, planes, scales, GROUP, **layout))
            worst = max(worst, float((got - want).abs().max()))
        out[name] = worst
    return out


if __name__ == "__main__":
    raise SystemExit(main())
