"""Serving launcher of the port: --arch <id> [--wire [--quality T] [--dense]] [--stream].

    python -m repro_torch.launch.serve --arch smollm_135m --full --wire --stream \
        --speculate lo:4

serves the published widths on the card (``--device cuda``, the default;
it raises without CUDA).  Without ``--full`` it serves the reduced smoke
config; ``--device cpu`` runs the plain PyTorch path.  Weights are random,
drawn from a ``torch.Generator`` seeded 0.

With ``--wire`` the model is compressed into a quality-dialed EdgeArtifact
and served through the facade (``repro_torch.api``): matmul weights stay
3-bit bit-planes end to end, ``--quality`` picks the serving tier (plane
truncation, never a re-quantization), and ``--dense`` decodes the whole
tree at load instead, for comparison.

The recurrent archs (``mamba2_1_3b``, ``jamba_1_5_large_398b``) and the
cross-attending ones (``llama_3_2_vision_11b``, ``whisper_tiny``: no image
or audio, their cross K/V zero) serve one tier per engine through
``generate()``'s static path (a per-token scanned prefill, then one
decode loop); ``--stream``, ``--mixed-tiers`` and ``--speculate`` refuse
them, as the JAX launcher does.

``--stream`` drives the continuous-batching scheduler instead of one
``generate()``: synthetic prompts arrive every ``--arrival-every`` engine
steps, join the running decode, and print as each request finishes with
its typed finish reason, waiting time and latency in steps.
``--mixed-tiers`` (with ``--wire``) cycles the arrivals through the
artifact's tiers, each served at its own tier in the one shared decode.
``--deadline``, ``--slo`` (QualityShed admission) and ``--max-queue``
are the robust-serving knobs.  ``--speculate TIER[:K]`` (with ``--wire
--stream``) drafts K tokens a round at TIER and verifies each window in
one serving-tier pass; the tokens equal plain serving, and the drafted
and accepted counts print per request and for the stream.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models.api import Model
from repro_torch.models.base import init_params, resolve_device
from repro_torch.quant.store import tree_bits_report
from repro_torch.serve import ServeConfig, ServeEngine


def _args(ap: argparse.ArgumentParser, argv):
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_135m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--wire", action="store_true",
                    help="compress to the QSQ wire artifact and serve it")
    ap.add_argument("--quality", default="hi", choices=api.DEFAULT_TIERS.names(),
                    help="with --wire: serving tier (plane truncation)")
    ap.add_argument("--dense", action="store_true",
                    help="with --wire: decode the whole tree at load instead of serving "
                         "packed bit-planes")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompts", type=int, default=None,
                    help="number of synthetic prompts (default: min(--slots, 3), or "
                         "--slots + 2 with --stream)")
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching: staggered arrivals admitted mid-decode")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="with --stream: engine steps between arrivals")
    ap.add_argument("--mixed-tiers", action="store_true",
                    help="with --wire --stream: cycle arrivals through the tiers")
    ap.add_argument("--deadline", type=float, default=None,
                    help="with --stream: per-request deadline in cost-clock units")
    ap.add_argument("--slo", type=float, default=None,
                    help="with --stream: QualityShed admission against this latency budget")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="with --stream: bound the queue; arrivals beyond it are REJECTED")
    ap.add_argument("--speculate", default=None, metavar="TIER[:K]",
                    help="with --wire --stream: draft K tokens a round (default 4) at TIER "
                         "and verify them in one serving-tier pass")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _validate(ap, args):
    """The JAX launcher's flag checks; returns the SpecConfig or None."""
    if args.slots < 1:
        ap.error("--slots must be >= 1")
    if args.prompts is None:
        args.prompts = args.slots + 2 if args.stream else min(args.slots, 3)
    elif args.prompts < 1:
        ap.error(f"--prompts must be >= 1; got {args.prompts}")
    elif not args.stream and args.prompts > args.slots:
        ap.error(f"--prompts must be in [1, --slots={args.slots}] without --stream (a "
                 f"static batch cannot queue); got {args.prompts}")
    if args.arrival_every < 1:
        ap.error("--arrival-every must be >= 1")
    if not args.wire and (args.quality != "hi" or args.dense):
        ap.error("--quality/--dense only apply with --wire")
    if args.mixed_tiers and not (args.wire and args.stream):
        ap.error("--mixed-tiers needs --wire --stream")
    if args.mixed_tiers and args.dense:
        ap.error("--mixed-tiers needs packed serving (drop --dense)")
    if not args.stream and (args.deadline is not None or args.slo is not None
                            or args.max_queue is not None):
        ap.error("--deadline/--slo/--max-queue only apply with --stream")
    if args.deadline is not None and args.deadline <= 0:
        ap.error("--deadline must be > 0")
    if args.max_queue is not None and args.max_queue < 0:
        ap.error("--max-queue must be >= 0")
    if args.speculate is None:
        return None
    if not (args.wire and args.stream) or args.dense:
        ap.error("--speculate needs --wire --stream packed serving")
    if args.mixed_tiers:
        ap.error("--speculate cannot combine with --mixed-tiers: the draft tier must sit "
                 "strictly below every request's serving tier")
    draft, _, kstr = args.speculate.partition(":")
    names = api.DEFAULT_TIERS.names()
    if draft not in names:
        ap.error(f"--speculate tier must be one of {names}; got {draft!r}")
    if names.index(draft) <= names.index(args.quality):
        ap.error(f"--speculate tier {draft!r} must sit strictly below the serving tier "
                 f"{args.quality!r}")
    try:
        k = int(kstr) if kstr else 4
    except ValueError:
        ap.error(f"--speculate window must be an integer; got {kstr!r}")
    if k < 1:
        ap.error(f"--speculate window must be >= 1; got {k}")
    return api.SpecConfig(draft, k)


def main(argv=None):
    ap = argparse.ArgumentParser()
    args = _args(ap, argv)
    speculate = _validate(ap, args)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    model = Model(cfg)
    params = init_params(model.param_descs(), device=device)

    admission = None
    if args.slo is not None:
        admission = api.QualityShed(api.SLOBudget(latency=args.slo, max_queue=args.max_queue))
    if args.wire:
        artifact = api.compress(model, params, device=device)
        engine = artifact.engine(quality=args.quality, batch_slots=args.slots,
                                 packed=not args.dense, admission=admission,
                                 max_queue=args.max_queue, device=device)
        rep = tree_bits_report(engine.params)
        print(f"serving tier {args.quality!r} from the QSQ wire artifact "
              f"({engine.n_packed_leaves} leaves served packed, "
              f"{rep['savings'] * 100:.0f}% below f32) on {device}")
    else:
        engine = ServeEngine(model, params, ServeConfig(
            batch_slots=args.slots, admission=admission, max_queue=args.max_queue),
            device=device)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=rng.randint(2, 6)).tolist()
               for _ in range(args.prompts)]
    if args.stream:
        tiers = None
        if args.mixed_tiers:
            if not engine.per_request_quality:
                ap.error("this artifact/config cannot serve per-request tiers (needs a "
                         "greedy attention family AND an artifact with a sensitivity "
                         "ranking — rebuild a bare wire with repro_torch.api.compress)")
            names = engine.tier_names
            tiers = [names[i % len(names)] for i in range(len(prompts))]
        if speculate is not None and not engine.per_request_quality:
            ap.error("--speculate needs per-request quality serving (a greedy attention "
                     "family and an artifact with a sensitivity ranking)")
        _serve_stream(engine, prompts, args.max_new, args.arrival_every, tiers=tiers,
                      deadline=args.deadline, speculate=speculate)
        return engine
    t0 = time.time()
    outs = engine.generate(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    for p, o in zip(prompts, outs, strict=True):
        print(f"  {p} -> {o}")
    n = len(prompts) * args.max_new
    print(f"{n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s)")
    return engine


def _serve_stream(engine, prompts, max_new: int, arrival_every: int, tiers=None,
                  deadline: float | None = None, speculate=None) -> None:
    """Prompt i arrives at step ``i * arrival_every`` and joins the running
    decode as soon as a slot frees; each request prints as it terminates."""
    t0 = time.time()
    pending = list(enumerate(prompts))
    rid_to_prompt = {}
    while pending or engine.has_work:
        step_idx = engine.step_count
        while pending and pending[0][0] * arrival_every <= step_idx:
            i, p = pending.pop(0)
            tier = tiers[i] if tiers is not None else None
            rid = engine.submit(p, max_new=max_new, quality=tier, deadline=deadline,
                                speculate=speculate)
            rid_to_prompt[rid] = p
            tag = f" @{tier}" if tier is not None else ""
            print(f"  step {step_idx:3d}  submit    r{rid}{tag} {p}")
        engine.step()
        for rid, st in engine.poll().items():
            tag = f" @{st.quality}" if st.quality is not None else ""
            where = (f"step {st.finished:3d}" if st.finished is not None
                     else f"step {step_idx:3d}")
            line = f"  {where}  {st.finish_reason.value:9s} r{rid}{tag} {rid_to_prompt[rid]}"
            if st.tokens:
                line += f" -> {st.tokens}"
            if st.drafted:
                line += f" [spec {st.accepted}/{st.drafted} accepted]"
            if st.waiting is not None and st.latency is not None:
                line += f" (waited {st.waiting}, latency {st.latency} steps)"
            elif st.detail:
                line += f" ({st.detail})"
            print(line)
    dt = time.time() - t0
    done = [r for r in engine.completed_requests.values()
            if r.waiting is not None and r.latency is not None]
    n = sum(len(r.out) for r in done)
    mean_wait = np.mean([r.waiting for r in done]) if done else 0.0
    mean_lat = np.mean([r.latency for r in done]) if done else 0.0
    print(f"{n} tokens / {len(rid_to_prompt)} requests in {dt:.2f}s ({n / dt:.1f} tok/s; "
          f"mean wait {mean_wait:.1f} steps, mean latency {mean_lat:.1f} steps)")
    if speculate is not None:
        st = engine.stream_stats()
        print(f"speculative: drafted {st['drafted']}, accepted {st['accepted']} (rate "
              f"{st['acceptance_rate']:.3f}); {st['bytes_per_token']:.0f} weight bytes per "
              f"accepted token ({st['read_frac']:.2f} of full-plane reads)")


if __name__ == "__main__":
    main()
