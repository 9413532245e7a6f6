"""Dry run of the port: every (arch x shape) cell traced on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m \\
        --shape decode_32k [--packed]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh 16x16 | --multi-pod]

The port of ``repro/launch/dryrun.py``.  Parameters, optimizer state,
caches and inputs are ``device="meta"`` tensors made from the descriptors
(``models.base.abstract_params``), and the real step functions run on them:
``make_train_step`` over a ``train_state_descs`` state, ``make_prefill_step``
and ``make_serve_step`` over ``cache_descs``.  A meta tensor has a shape, a
dtype and strides but no data, and the QSQ kernels' wrappers return empty
meta outputs, so the trace computes no value, allocates no memory and needs
no card.  This is not a CPU fallback: nothing runs anywhere, as nothing
runs on the JAX dry run's placeholder devices.  One trace gives, per device
of the one-card mesh (the default, "1x1"):

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the step,
  plus the packed matmuls' 2 M K N, which no dispatch mode sees
  (``kernels.qsq.work``);
* ``bytes_accessed``: every dispatched op's input and output bytes (XLA's
  cost-analysis convention; views and bare allocations count none), plus
  each packed matmul's planes, scales, x and output and the encoder's w,
  codes and scales; ``host_to_device_bytes``, what the step copies from
  host tensors onto the device (a step that does cannot be captured);
* ``temp_bytes``: the peak of the live bytes of the storages the step makes,
  each followed from the op that makes it to its release (:class:`_Trace`),
  so ``peak_bytes`` = arguments + temp is the most the card holds for it;
* ``argument_bytes`` and ``output_bytes`` from the descriptors' partition
  specs on the mesh, as the sharded tensors would hold them.

The port traces every layer, so nothing is extrapolated; the 1- and 2-unit
probes (``probes_raw``) are traced too, and their linear extrapolation
meets the full trace wherever the layers are alike.

On a mesh of more than one device (``--mesh 16x16``, ``--multi-pod``) the
step would be a sharded program, which the port does not have yet: FLOPs,
bytes accessed, temp and collective bytes stay null, with the reason under
``null_reasons``; the argument and output bytes are computed.

Results: ``build/dryrun/<arch>__<shape>__<mesh>[__<tag>].json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import weakref
from pathlib import Path
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cell_is_supported, get_arch
from repro_torch.core.energy import roofline_terms
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import (
    Mesh,
    make_debug_mesh,
    make_production_mesh,
    mesh_axis_sizes,
    sharding_rules,
)
from repro_torch.models.api import Model
from repro_torch.models.base import (
    ParamDesc,
    abstract_params,
    desc_leaves,
    set_activation_rules,
    spec_for_shape,
)
from repro_torch.optim import GradCompressionConfig
from repro_torch.quant.packed import packed_param_descs
from repro_torch.train.state import train_state_descs
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {m.name: m for m in (make_debug_mesh(1, 1), make_production_mesh(),
                              make_production_mesh(multi_pod=True))}
_SHARDED = ("the port has no sharded program yet (the multi-GPU slice): a one-device "
            "trace is not what each of the mesh's devices computes, holds or sends")
_TRACED_KEYS = ("flops", "bytes_accessed", "collective_bytes_extrapolated", "temp_bytes",
                "peak_bytes", "host_to_device_bytes")

_aten = torch.ops.aten
# ops that move no element: bare allocations, and a reshape's view of a copy
_NO_BYTES = frozenset({_aten.empty.memory_format, _aten.empty_strided.default,
                       _aten.empty_like.default, _aten.new_empty.default,
                       _aten.new_empty_strided.default, _aten._unsafe_view.default})
_COPIES = frozenset({_aten._to_copy.default, _aten.copy_.default})
# in-place writes of indexed slots: they read their index and value operands
# and write as many elements as the values hold, not the whole destination
_INDEXED_WRITES = frozenset({_aten.index_put_.default, _aten.scatter_.src,
                             _aten.scatter_add_.default, _aten.index_copy_.default,
                             _aten.index_add_.default})


def model_flops_estimate(model: Model, shape: ShapeConfig):
    """6 * N_active * D (train) / 2 * N_active * tokens (decode/prefill)
    -> (model FLOPs, N, N_active)."""
    cfg = model.cfg
    n_total = 0
    n_active = 0.0
    for d in desc_leaves(model.param_descs()):
        numel = math.prod(d.shape)
        n_total += numel
        if "experts" in d.axes and cfg.moe is not None:
            n_active += numel * cfg.moe.top_k / cfg.moe.n_experts
        else:
            n_active += numel
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens, n_total, n_active


def probe_granularity(cfg) -> int:
    """Smallest layer count that preserves the arch's block structure."""
    if cfg.family == "hybrid":
        return cfg.hybrid.period
    if cfg.family == "vlm":
        return cfg.cross_every
    return 1


def probe_config(cfg, mult: int):
    """Reduced-depth copy of cfg (same widths): ``mult`` block units."""
    g = probe_granularity(cfg)
    changes = {"n_layers": g * mult}
    if cfg.family == "encdec":
        changes["enc_layers"] = mult
    return dataclasses.replace(cfg, **changes)


class Cell(NamedTuple):
    step: Callable
    descs: tuple  # one descriptor tree per positional argument of ``step``
    out_descs: tuple  # descriptors of what ``step`` returns
    model: Model
    shape: ShapeConfig


def _shape(shape: str | ShapeConfig) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch_id: str, shape: str | ShapeConfig, *, cfg_override=None,
               packed: bool = False, cc: GradCompressionConfig | None = None) -> Cell:
    """The step of a cell and the descriptors of its arguments and outputs.

    ``shape`` is a name of :data:`SHAPES` or a ShapeConfig; ``packed``
    serves decode/prefill shapes with QSQ bit-plane weights; ``cc``
    configures the train step's gradient compression (off by default)."""
    cfg = cfg_override if cfg_override is not None else get_arch(arch_id)
    model = Model(cfg)
    shape = _shape(shape)
    b = shape.global_batch
    batch = model.input_descs(shape)
    if shape.kind == "train":
        state = train_state_descs(model, cc)
        metrics = {k: ParamDesc((), (), dtype=torch.float32)
                   for k in ("grad_norm", "loss", "lr_scale")}
        return Cell(make_train_step(model, cc=cc), (state, batch), (state, metrics), model,
                    shape)
    params = model.param_descs()
    if packed:
        params = packed_param_descs(params)
    if shape.kind == "prefill":
        logits = ParamDesc((b, shape.seq_len, cfg.vocab), ("batch", "seq_act", "vocab"))
        return Cell(make_prefill_step(model), (params, batch), (logits,), model, shape)
    cache = model.cache_descs(b, shape.seq_len)
    tokens = ParamDesc((b, 1), ("batch", None), dtype=torch.int32)
    return Cell(make_serve_step(model), (params, cache, batch), (tokens, cache), model, shape)


def device_bytes(descs, rules, sizes) -> int:
    """Bytes one device holds of a descriptor tree laid out by its partition
    specs (a sharded dim holds size / the product of its mesh axes)."""
    total = 0
    for d in desc_leaves(descs):
        n = d.dtype.itemsize
        for size, entry in zip(d.shape, spec_for_shape(d.shape, d.axes, rules, sizes),
                               strict=True):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n *= size // math.prod(sizes[a] for a in axes)
        total += n
    return total


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Trace(TorchDispatchMode):
    """Follows a step op by op: the bytes each op reads and writes (its
    inputs and outputs; none for views and bare allocations; an indexed
    write its indices and values, read, and its values again, written), the
    bytes copied from host tensors onto the device, and the live bytes of
    the storages the step makes, each from the op that makes it to its
    release (a finalizer on the storage), with their peak."""

    def __init__(self):
        super().__init__()
        self.bytes = self.host_bytes = 0
        self.live: dict[int, int] = {}
        self.cur = self.peak = 0

    def _release(self, key: int) -> None:
        self.cur -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func in _INDEXED_WRITES:
            self.bytes += sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1])
        elif not func.is_view and func not in _NO_BYTES:
            self.bytes += sum(map(_nbytes, ins + outs))
        if func in _COPIES and ins[-1].is_cpu and not outs[0].is_cpu:
            self.host_bytes += _nbytes(outs[0])
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue  # an input's storage, or one already followed
            self.live[key] = st.nbytes()
            self.cur += st.nbytes()
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._release, key)
        return out


def trace_cell(cell: Cell) -> dict:
    """Run the cell's step on meta stand-ins of its arguments -> its FLOPs,
    bytes accessed, bytes copied from the host, temp bytes (peak live bytes
    the step makes) and the dispatch counters and plane traffic it adds."""
    args = [abstract_params(d) for d in cell.descs]
    with dispatch.record_counts() as delta:
        with FlopCounterMode(display=False) as fc, _Trace() as tr:
            cell.step(*args)
    counters, traffic, launches, work = delta
    if +launches:
        raise RuntimeError(f"a kernel launched in a meta trace: {dict(launches)}")
    return {"flops": fc.get_total_flops() + work["flops"], "bytes": tr.bytes + work["bytes"],
            "host_bytes": tr.host_bytes, "temp_bytes": tr.peak, "counters": dict(+counters),
            "traffic": dict(+traffic)}


def run_cell(arch_id: str, shape: str | ShapeConfig, *, mesh: str = "1x1",
             multi_pod: bool = False, fsdp: bool = True, save: bool = True, tag: str = "",
             packed: bool = False, probes_enabled: bool = True,
             cfg_override=None, cc: GradCompressionConfig | None = None) -> dict:
    """One cell's account (the JAX dry run's keys) on ``mesh`` ("1x1",
    "16x16"; ``multi_pod`` takes "2x16x16"), saved under :data:`RESULTS_DIR`
    when ``save``.  ``cfg_override`` replaces the arch's config (its probes
    are cut from it); ``cc`` as in :func:`build_cell`."""
    the_mesh: Mesh = make_production_mesh(multi_pod=True) if multi_pod else MESHES[mesh]
    shape = _shape(shape)
    cfg = cfg_override if cfg_override is not None else get_arch(arch_id)
    ok, reason = cell_is_supported(cfg, shape)
    result: dict[str, Any] = {
        "arch": arch_id, "shape": shape.name, "mesh": the_mesh.name, "chips": the_mesh.size,
        "supported": ok, "device": "meta", "packed": packed,
    }
    if not ok:
        result["skip_reason"] = reason
        if save:
            _save(result, tag)
        return result

    rules = sharding_rules(the_mesh, fsdp=fsdp)
    sizes = mesh_axis_sizes(the_mesh)
    n_chips = the_mesh.size
    kw = dict(packed=packed, cc=cc)
    cell = build_cell(arch_id, shape, cfg_override=cfg, **kw)
    mflops, n_total, n_active = model_flops_estimate(cell.model, shape)
    g = probe_granularity(cfg)
    ratio = cfg.n_layers // g
    per_device = {
        "argument_bytes": sum(device_bytes(d, rules, sizes) for d in cell.descs),
        "output_bytes": sum(device_bytes(d, rules, sizes) for d in cell.out_descs),
        "collective_bytes_scan_module": None,
    }
    null_reasons = {
        "compile_s": "nothing compiles: the step runs eagerly on meta tensors",
        "collective_bytes_scan_module": "no HLO module: the port has no compiler output to "
                                        "read collectives from",
    }
    if n_chips > 1:
        per_device.update(dict.fromkeys(_TRACED_KEYS))
        null_reasons.update(dict.fromkeys(
            (*_TRACED_KEYS, "lower_s", "probe_s", "probes_raw", "useful_flops_ratio",
             "roofline", "dispatch"), _SHARDED))
        result.update(lower_s=None, compile_s=None, probe_s=None, probes_raw=None,
                      layer_extrapolation_ratio=ratio, per_device=per_device,
                      model_flops=mflops, n_params=n_total, n_params_active=n_active,
                      useful_flops_ratio=None, roofline=None, dispatch=None,
                      null_reasons=null_reasons)
        if save:
            _save(result, tag)
        return result

    probe_cells = [build_cell(arch_id, shape, cfg_override=probe_config(cfg, mult), **kw)
                   for mult in (1, 2)]
    set_activation_rules(rules, the_mesh)
    try:
        # a process's first step fills per-device caches that later steps
        # only read (RoPE frequencies, level tables): the 1-unit probe's
        # step fills them untraced, so every trace below is a later step
        with dispatch.record_counts():
            probe_cells[0].step(*[abstract_params(d) for d in probe_cells[0].descs])
        t0 = time.time()
        full = trace_cell(cell)
        t_lower = time.time() - t0
        probes = [trace_cell(c) for c in (probe_cells if probes_enabled else ())]
        t_probe = time.time() - t0 - t_lower
    finally:
        set_activation_rules(None)

    per_device.update(flops=float(full["flops"]), bytes_accessed=float(full["bytes"]),
                      collective_bytes_extrapolated=0.0, temp_bytes=full["temp_bytes"],
                      host_to_device_bytes=full["host_bytes"],
                      peak_bytes=per_device["argument_bytes"] + full["temp_bytes"])
    rt = roofline_terms(per_device["flops"] * n_chips, per_device["bytes_accessed"] * n_chips,
                        0.0, n_chips)
    result.update({
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "probe_s": round(t_probe, 2),
        "probes_raw": [{"flops": float(p["flops"]), "bytes": float(p["bytes"]), "coll": 0}
                       for p in probes],
        "layer_extrapolation_ratio": ratio,
        "per_device": per_device,
        "model_flops": mflops,
        "n_params": n_total,
        "n_params_active": n_active,
        "useful_flops_ratio": mflops / max(per_device["flops"] * n_chips, 1.0),
        "roofline": rt,
        "dispatch": {"counters": full["counters"], "traffic": full["traffic"]},
        "null_reasons": null_reasons,
    })
    if save:
        _save(result, tag)
    return result


def _save(result: dict, tag: str = "") -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}{suffix}.json"
    (RESULTS_DIR / name).write_text(json.dumps(result, indent=2, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="1x1",
                    help="the one card (default) or a planned JAX mesh")
    ap.add_argument("--multi-pod", action="store_true", help="plan the 2x16x16 mesh")
    ap.add_argument("--all", action="store_true", help="all 40 cells on this mesh")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="QSQ bit-plane weights for decode/prefill shapes")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the 1- and 2-unit probe traces")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failed = 0
    for arch, shp in cells:
        try:
            r = run_cell(arch, shp, mesh=args.mesh, multi_pod=args.multi_pod,
                         fsdp=not args.no_fsdp, tag=args.tag, packed=args.packed,
                         probes_enabled=not args.no_probes)
        except Exception as e:  # noqa: BLE001 -- report and continue the sweep
            print(f"FAIL {arch} {shp}: {type(e).__name__}: {e}")
            failed += 1
            continue
        pd = r.get("per_device", {})
        if not r["supported"]:
            print(f"SKIP {arch} {shp}: {r['skip_reason']}")
        elif r["roofline"] is None:
            print(f"OK {arch} {shp} mesh={r['mesh']} "
                  f"argument={pd['argument_bytes'] / 1e9:.3f}GB/device "
                  f"output={pd['output_bytes'] / 1e9:.3f}GB/device (not traced: sharded)")
        else:
            rt = r["roofline"]
            print(f"OK {arch} {shp} mesh={r['mesh']} trace={r['lower_s']}s "
                  f"peak={pd['peak_bytes'] / 1e9:.3f}GB "
                  f"compute={rt['compute_s']:.3e}s memory={rt['memory_s']:.3e}s "
                  f"coll={rt['collective_s']:.3e}s dom={rt['dominant']} "
                  f"frac={rt['roofline_fraction']:.2f} useful={r['useful_flops_ratio']:.2f}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
