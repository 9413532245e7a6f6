"""The port's qsqlint configuration: rule selection, per-rule knobs, allowlists.

The defaults are the port's own contracts: its hot-path packages, the
capture call of ``serve/graphs.py``, the step factories of
``train/step.py``, the kernels' modules and their plain versions, and the
counter objects of the dispatcher and the kernel wrappers.  Nothing is read
from ``pyproject.toml``; a JSON file (``--config``) and keyword overrides
replace any key.

Allowlist entries are strings ``"RULE:path-glob"`` or
``"RULE:path-glob:qualname"``: a violation of RULE inside a matching file
(and, when given, inside the named function scope) is suppressed without
an inline pragma.  Pragmas are preferred for one-off exemptions (they sit
next to the code and carry a justification); the allowlist is for
structural ones.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from pathlib import Path

#: Rules every run enables unless --select/--ignore narrows them.
ALL_RULES = ("QSQ001", "QSQ002", "QSQ003", "QSQ004", "QSQ005")

#: What ``python -m repro_torch.analysis`` lints when given no paths: the
#: port's files (globs relative to the root).
DEFAULT_PATHS = (
    "src/repro_torch",
    "tests/test_torch_*.py",
    "tests/torch_port_scope.py",
    "examples/torch_*.py",
    "chip_smoke.py",
)

_DEFAULTS: dict = {
    # QSQ001: packages where a dense-materializing call is a hot-path bug
    "hot_paths": [
        "src/repro_torch/serve",
        "src/repro_torch/models",
        "src/repro_torch/kernels",
    ],
    # QSQ001: call names that materialize a dense weight from a store leaf
    "dense_calls": ["as_dense", "dequantize", "dense_tree"],
    # QSQ002/QSQ003: parameter names that select what a captured step is
    # (plane demand and friends): static inside a capture context, and part
    # of the key of every capture that threads them
    "static_params": [
        "demand",
        "demand_tier",
        "demand_drop",
        "drop",
        "plane_major",
        "sign_mag",
    ],
    # QSQ003: names that are buffer contents by design (a tier flip or an
    # admission is a copy into a static buffer); a key on them captures once
    # per value
    "never_static": ["plane_mask", "tiers", "active"],
    # QSQ002/QSQ003: "<class path>.<method>" of the capture call; the key is
    # its first argument and the step closure its second, as in
    # ``s.graphs.run(key, fn, restore)``
    "capture_calls": ["repro_torch.serve.graphs.StepGraphs.run"],
    # QSQ002: modules whose step factories' products run under capture (the
    # port's counterpart of the products the JAX package jits)
    "step_factory_modules": ["src/repro_torch/train/step.py"],
    # QSQ005: the per-call counter objects, fully qualified
    "counter_objects": [
        "repro_torch.kernels.dispatch.counters",
        "repro_torch.kernels.dispatch.traffic",
        "repro_torch.kernels.qsq.launches",
        "repro_torch.kernels.qsq.work",
    ],
    # QSQ005: the only scopes allowed to mutate them ("path::qualname";
    # "<module>" is module level, for the defining assignments)
    "counter_scopes": [
        "src/repro_torch/kernels/dispatch.py::<module>",
        "src/repro_torch/kernels/dispatch.py::reset_counters",
        "src/repro_torch/kernels/dispatch.py::record_counts",
        "src/repro_torch/kernels/dispatch.py::add_counts",
        "src/repro_torch/kernels/dispatch.py::packed_matmul",
        "src/repro_torch/kernels/qsq.py::<module>",
        "src/repro_torch/kernels/qsq.py::reset_launches",
        "src/repro_torch/kernels/qsq.py::_launch",
        "src/repro_torch/kernels/qsq.py::qsq_quantize",
    ],
    # QSQ004: the modules that build and launch the kernels
    "kernel_modules": [
        "src/repro_torch/kernels/qsq.py",
        "src/repro_torch/kernels/dispatch.py",
        "src/repro_torch/kernels/build.py",
    ],
    # QSQ004: the plain versions, which run only on CPU tensors
    "plain_modules": ["repro_torch.kernels.ref"],
    # QSQ004: calls that decide "these tensors lie on the CPU"
    "cpu_guards": ["_on_cpu"],
    # global allowlist entries: "RULE:path-glob[:qualname]"
    "allow": [],
}


def _under(path: str, prefixes) -> bool:
    p = path.replace("\\", "/")
    return any(p == hp or p.startswith(hp.rstrip("/") + "/") for hp in prefixes)


@dataclasses.dataclass(frozen=True)
class Config:
    """Resolved configuration (immutable; see the module docstring)."""

    select: tuple[str, ...] = ALL_RULES
    hot_paths: tuple[str, ...] = tuple(_DEFAULTS["hot_paths"])
    dense_calls: tuple[str, ...] = tuple(_DEFAULTS["dense_calls"])
    static_params: tuple[str, ...] = tuple(_DEFAULTS["static_params"])
    never_static: tuple[str, ...] = tuple(_DEFAULTS["never_static"])
    capture_calls: tuple[str, ...] = tuple(_DEFAULTS["capture_calls"])
    step_factory_modules: tuple[str, ...] = tuple(_DEFAULTS["step_factory_modules"])
    counter_objects: tuple[str, ...] = tuple(_DEFAULTS["counter_objects"])
    counter_scopes: tuple[str, ...] = tuple(_DEFAULTS["counter_scopes"])
    kernel_modules: tuple[str, ...] = tuple(_DEFAULTS["kernel_modules"])
    plain_modules: tuple[str, ...] = tuple(_DEFAULTS["plain_modules"])
    cpu_guards: tuple[str, ...] = tuple(_DEFAULTS["cpu_guards"])
    allow: tuple[str, ...] = ()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # -- queries the rules ask ---------------------------------------------
    def is_hot_path(self, path: str) -> bool:
        return _under(path, self.hot_paths)

    def is_step_factory_module(self, path: str) -> bool:
        return _under(path, self.step_factory_modules)

    def is_kernel_module(self, path: str) -> bool:
        return _under(path, self.kernel_modules)

    def is_plain(self, name: str) -> bool:
        return any(name.startswith(m + ".") for m in self.plain_modules)

    def capture_methods(self) -> dict[str, str]:
        """Capture class (bare name) -> the method that captures."""
        out = {}
        for entry in self.capture_calls:
            cls, _, method = entry.rpartition(".")
            out[cls.rsplit(".", 1)[-1]] = method
        return out

    def counter_scope_allowed(self, path: str, qualname: str) -> bool:
        key = f"{path}::{qualname}"
        return any(fnmatch.fnmatch(key, pat) for pat in self.counter_scopes)

    def allowlisted(self, rule: str, path: str, qualname: str) -> bool:
        for entry in self.allow:
            parts = entry.split(":")
            if len(parts) < 2 or parts[0] != rule:
                continue
            glob, func = parts[1], (parts[2] if len(parts) > 2 else None)
            if not fnmatch.fnmatch(path, glob):
                continue
            if func is None or func == qualname or qualname.endswith("." + func):
                return True
        return False


def _merge(base: Config, overrides: dict) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    kw = {}
    for key, val in overrides.items():
        name = key.replace("-", "_")
        if name not in known:
            raise KeyError(f"unknown qsqlint config key {key!r}")
        kw[name] = tuple(val) if isinstance(val, (list, tuple)) else val
    return base.replace(**kw)


def load_config(config_file: str | Path | None = None,
                overrides: dict | None = None) -> Config:
    """The effective Config: built-in defaults < ``config_file`` (JSON) <
    ``overrides``."""
    cfg = Config(allow=tuple(_DEFAULTS["allow"]))
    if config_file is not None:
        with open(config_file) as f:
            cfg = _merge(cfg, json.load(f))
    if overrides:
        cfg = _merge(cfg, overrides)
    return cfg


def default_paths(root: str | Path = ".") -> list[Path]:
    """:data:`DEFAULT_PATHS` expanded under ``root`` (those that exist)."""
    root = Path(root)
    out: list[Path] = []
    for pat in DEFAULT_PATHS:
        out.extend(sorted(root.glob(pat)) if "*" in pat else
                   [root / pat] if (root / pat).exists() else [])
    return out
