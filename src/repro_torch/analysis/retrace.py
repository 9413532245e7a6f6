"""Assert that a block of serving captures no new CUDA graph.

The port's counterpart of ``repro/analysis/retrace.py::no_retrace``.  The
engine keys its captured steps by static arguments alone (``demand``; the
verify also by window width), so admissions, evictions, cancels and tier
flips are copies into static buffers and never a new capture.
:func:`no_recapture` checks that at run time::

    with no_recapture(eng):
        for _ in range(32):
            eng.step()          # admits, evicts and re-tiers freely

It watches the key set of the engine's stream session, which grows on
the CPU and in eager mode exactly as it would on the card, so the check
runs there too.

:func:`entered_functions` records the Python functions a block enters,
so a test can hold what runs under capture against the linter's capture
contexts (``linter.capture_contexts``).
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path


def _keys(engine) -> set:
    return set() if engine._session is None else set(engine._session.graphs.keys())


@contextlib.contextmanager
def no_recapture(engine):
    """Fail if ``engine``'s stream adds a graph key (a capture on the card)
    inside the block.  A stream first made inside the block counts from
    empty."""
    before = _keys(engine)
    yield
    grown = _keys(engine) - before
    if grown:
        raise AssertionError(f"new captures inside a no_recapture() block: "
                             f"{sorted(map(repr, grown))}")


@contextlib.contextmanager
def entered_functions(root):
    """Record, with ``sys.setprofile``, the Python functions entered inside
    the block in files under ``root``.  The yielded set receives, on exit,
    ``(path relative to root, qualname)`` pairs, the qualname as the linter
    spells it (``ServeEngine._decode_call.<lambda>``, no ``<locals>``)."""
    root = Path(root).resolve()
    codes: set = set()

    def profile(frame, event, arg):
        if event == "call":
            codes.add(frame.f_code)

    out: set[tuple[str, str]] = set()
    prev = sys.getprofile()
    sys.setprofile(profile)
    try:
        yield out
    finally:
        sys.setprofile(prev)
        for code in codes:
            try:
                rel = Path(code.co_filename).resolve().relative_to(root)
            except ValueError:
                continue
            out.add((rel.as_posix(), code.co_qualname.replace(".<locals>", "")))
