"""CLI entry point: ``python -m repro_torch.analysis [paths...]``.

With no paths it lints the port's files (``config.DEFAULT_PATHS``).
Exit codes: 0 clean, 1 violations found, 2 usage/config error.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.config import ALL_RULES, DEFAULT_PATHS, default_paths, load_config
from repro_torch.analysis.linter import lint_paths


def _parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=("qsqlint for the PyTorch port: capture hygiene, packed-weight and "
                     "kernel-route invariants (QSQ001..QSQ005)"),
    )
    parser.add_argument(
        "paths", nargs="*",
        help=f"files or directories to lint (default: {' '.join(DEFAULT_PATHS)})")
    parser.add_argument(
        "--select", metavar="RULES",
        help="comma-separated rule ids to run (default: all)")
    parser.add_argument(
        "--ignore", metavar="RULES",
        help="comma-separated rule ids to skip")
    parser.add_argument(
        "--config", metavar="FILE",
        help="JSON config file overriding the defaults")
    parser.add_argument(
        "--root", default=".",
        help="repo root for relative paths + config matching (default: .)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit")
    return parser.parse_args(argv)


def _list_rules() -> None:
    from repro_torch.analysis.rules import RULES

    for rule_id in ALL_RULES:
        cls = RULES[rule_id]
        print(f"{rule_id}  {cls.name:<24} {cls.summary}")


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.list_rules:
        _list_rules()
        return 0

    try:
        config = load_config(config_file=args.config)
        select = list(config.select)
        if args.select:
            select = [r.strip() for r in args.select.split(",") if r.strip()]
        if args.ignore:
            ignored = {r.strip() for r in args.ignore.split(",")}
            select = [r for r in select if r not in ignored]
        unknown = [r for r in select if r not in ALL_RULES]
        if unknown:
            print(f"qsqlint: unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
        config = config.replace(select=tuple(select))
    except (OSError, KeyError, ValueError) as e:
        print(f"qsqlint: config error: {e}", file=sys.stderr)
        return 2

    violations = lint_paths(args.paths or default_paths(args.root), config=config,
                            root=args.root)
    for v in violations:
        print(v.format())
    if violations:
        print(f"qsqlint: {len(violations)} violation(s) in "
              f"{len({v.path for v in violations})} file(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
