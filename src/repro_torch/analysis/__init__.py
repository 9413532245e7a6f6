"""Static and run-time checks of the port (the counterpart of ``repro.analysis``).

The port's speed and correctness rest on contracts no general linter
knows: packed weights never materialize dense on a hot path, a captured
serving step never syncs the host, a capture key holds the step's static
arguments and nothing that is buffer contents, a CUDA tensor runs its
kernel or raises, and the per-call counters mutate only in their helpers.
This package checks them on the AST:

* :mod:`repro_torch.analysis.rules`   — the QSQ001..QSQ005 rule registry;
* :mod:`repro_torch.analysis.linter`  — file/project orchestration, pragmas
  and :func:`capture_contexts`, the bodies the linter treats as captured;
* :mod:`repro_torch.analysis.config`  — per-rule config and allowlists;
* :mod:`repro_torch.analysis.retrace` — the run-time companions
  (:func:`~repro_torch.analysis.retrace.no_recapture`, and
  :func:`~repro_torch.analysis.retrace.entered_functions`, which records
  what a block runs so it can be held against the capture contexts).

CLI: ``python -m repro_torch.analysis [paths]`` (nonzero exit on
violations).  Inline suppression: ``# qsqlint: disable=QSQ001 -- why``.
"""
from repro_torch.analysis.config import Config, load_config
from repro_torch.analysis.linter import Violation, capture_contexts, lint_file, lint_paths
from repro_torch.analysis.retrace import entered_functions, no_recapture
from repro_torch.analysis.rules import RULES

__all__ = [
    "Config",
    "RULES",
    "Violation",
    "capture_contexts",
    "entered_functions",
    "lint_file",
    "lint_paths",
    "load_config",
    "no_recapture",
]
