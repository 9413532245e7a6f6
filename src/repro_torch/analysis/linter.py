"""The port's qsqlint core: file loading, pragmas, the project pass, reporting.

A lint run is two passes.  Pass one parses every file and builds a
:class:`ProjectIndex`: the step factories, the attributes that hold a
capture object (``self.graphs = StepGraphs(...)`` in ``serve/engine.py``),
then every module's capture sites and the factories their run closures
reach (``self._cont_step = make_cont_decode_step(model)``), so a capture in
``serve/engine.py`` marks a product of ``train/step.py``.  Pass two runs
every enabled rule per file and filters the findings through inline
pragmas and the config allowlist.

Pragma syntax (the JAX package's; one form serves the whole repo)::

    planes = p.as_dense()  # qsqlint: disable=QSQ001 -- cold path: <why>
    # qsqlint: disable-file=QSQ002 -- whole-file suppression

Multiple rules separate with commas; ``all`` disables everything.  The
`` -- why`` justification is free text; keep one.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

from repro_torch.analysis.astutil import (
    CaptureContext,
    ModuleAnalysis,
    static_params_of,
)
from repro_torch.analysis.config import Config

PRAGMA_RE = re.compile(
    r"#\s*qsqlint:\s*(?P<kind>disable(?:-file)?)\s*=\s*(?P<rules>[A-Za-z0-9_,\s]+?)"
    r"\s*(?:--.*)?$"
)

_ALL = "all"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: where, which rule, why it matters."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    qualname: str = "<module>"  # enclosing function scope, for allowlists

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass
class Pragmas:
    file_rules: set[str]
    line_rules: dict[int, set[str]]

    def suppressed(self, rule: str, line: int) -> bool:
        for rules in (self.file_rules, self.line_rules.get(line, ())):
            if _ALL in rules or rule in rules:
                return True
        return False


def parse_pragmas(source: str) -> Pragmas:
    """Trailing pragmas suppress their own line; a pragma on a
    comment-only line suppresses the next code line (so multi-line
    justifications above a statement work)."""
    pragmas = Pragmas(file_rules=set(), line_rules={})
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except tokenize.TokenError:
        comments = [(i + 1, line.strip()) for i, line in
                    enumerate(lines) if "#" in line]

    def _attach_line(lineno: int) -> int:
        # standalone comment: walk down past comments/blanks to the code line
        if not lines[lineno - 1].lstrip().startswith("#"):
            return lineno
        at = lineno
        while at < len(lines):
            stripped = lines[at].strip()  # 0-based `at` is the NEXT line
            if stripped and not stripped.startswith("#"):
                return at + 1
            at += 1
        return lineno

    for lineno, text in comments:
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        if m.group("kind") == "disable-file":
            pragmas.file_rules |= rules
        else:
            pragmas.line_rules.setdefault(
                _attach_line(lineno), set()).update(rules)
    return pragmas


@dataclasses.dataclass
class FileContext:
    """Everything a rule may consult about one file under lint."""

    path: str          # repo-relative posix path (display + config matching)
    source: str
    tree: ast.Module
    analysis: ModuleAnalysis
    pragmas: Pragmas
    config: Config
    index: "ProjectIndex"


class ProjectIndex:
    """Cross-file facts, built before any rule runs."""

    def __init__(self):
        # canonical factory name -> FactoryInfo (also indexed by bare name
        # when unambiguous, for same-project resolution across modules)
        self.factories: dict[str, object] = {}
        self._by_bare: dict[str, list] = {}
        self.modules: list[ModuleAnalysis] = []
        self.capture_attrs: set[str] = set()
        # canonical names of the factories a run closure reaches
        self.resolved: set[str] = set()

    def add_module(self, analysis: ModuleAnalysis) -> None:
        for info in analysis.factories.values():
            self.factories[f"{info.module}.{info.name}"] = info
            self._by_bare.setdefault(info.name, []).append(info)
        self.capture_attrs |= analysis.capture_attrs
        self.modules.append(analysis)

    def finish(self) -> None:
        """Find every module's capture sites and the factories they reach."""
        for analysis in self.modules:
            analysis.find_capture_sites(self.capture_attrs)
            for name in analysis.resolved_factories():
                info = self.find_factory(name)
                if info is not None:
                    self.resolved.add(f"{info.module}.{info.name}")

    def find_factory(self, canonical_name: str):
        info = self.factories.get(canonical_name)
        if info is not None:
            return info
        candidates = self._by_bare.get(canonical_name.rsplit(".", 1)[-1], [])
        return candidates[0] if len(candidates) == 1 else None


def file_capture_contexts(ctx: FileContext) -> dict[ast.AST, CaptureContext]:
    """The capture contexts that lie in this file (see ``astutil``'s module
    doc): run closures, step-factory products, resolved products."""
    analysis, statics = ctx.analysis, set(ctx.config.static_params)
    out: dict[ast.AST, CaptureContext] = {}

    def add(fn, reason):
        if fn in out:
            out[fn].reasons.add(reason)
        else:
            out[fn] = CaptureContext(fn, static_params_of(fn, statics), {reason})

    for site in analysis.capture_sites:
        if site.closure is not None:
            add(site.closure, "run-closure")
    for info in analysis.factories.values():
        canonical = f"{info.module}.{info.name}"
        for product in info.products:
            if ctx.config.is_step_factory_module(ctx.path):
                add(product, "factory-product")
            if canonical in ctx.index.resolved:
                add(product, "resolved")
    return out


def module_dotted(path: str) -> str:
    """Best-effort dotted module path from a repo-relative file path."""
    p = Path(path)
    parts = list(p.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<unknown>"


def iter_python_files(paths: list[str | Path], root: Path) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = (root / p) if not Path(p).is_absolute() else Path(p)
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts
            ))
        elif p.suffix == ".py":
            files.append(p)
    return files


def _display_path(file: Path, root: Path) -> str:
    try:
        return file.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return file.as_posix()


def _build_context(file: Path, root: Path, config: Config,
                   index: ProjectIndex) -> FileContext | Violation:
    rel = _display_path(file, root)
    source = file.read_text()
    try:
        tree = ast.parse(source, filename=str(file))
    except SyntaxError as e:
        return Violation(path=rel, line=e.lineno or 1, col=e.offset or 0,
                         rule="QSQ000", message=f"syntax error: {e.msg}")
    analysis = ModuleAnalysis(tree, rel, module_dotted(rel),
                              capture_classes=config.capture_methods())
    return FileContext(path=rel, source=source, tree=tree, analysis=analysis,
                       pragmas=parse_pragmas(source), config=config,
                       index=index)


def _project(paths, config: Config, root: Path):
    contexts: list[FileContext] = []
    errors: list[Violation] = []
    index = ProjectIndex()
    for file in iter_python_files(paths, root):
        ctx = _build_context(file, root, config, index)
        if isinstance(ctx, Violation):
            errors.append(ctx)
            continue
        index.add_module(ctx.analysis)
        contexts.append(ctx)
    index.finish()
    return contexts, errors


def lint_paths(paths: list[str | Path], config: Config | None = None,
               root: str | Path = ".") -> list[Violation]:
    """Lint every .py under ``paths`` (files or directories) and return
    surviving violations, sorted by (path, line, col, rule)."""
    return lint_report(paths, config, root)[0]


def lint_report(paths: list[str | Path], config: Config | None = None,
                root: str | Path = ".") -> tuple[list[Violation], dict]:
    """:func:`lint_paths` and a summary: ``files`` linted and ``pragmas``,
    the line pragmas that suppressed a finding, by rule."""
    from repro_torch.analysis.rules import RULES

    config = config or Config()
    contexts, errors = _project(paths, config, Path(root))
    violations = list(errors)
    enabled = [RULES[r] for r in config.select if r in RULES]
    seen: set[Violation] = set()
    honoured: dict[str, int] = {}
    for ctx in contexts:
        for rule in enabled:
            for v in rule().check(ctx):
                if v in seen:  # e.g. one site reached by two contexts
                    continue
                seen.add(v)
                if ctx.pragmas.suppressed(v.rule, v.line):
                    honoured[v.rule] = honoured.get(v.rule, 0) + 1
                    continue
                if config.allowlisted(v.rule, v.path, v.qualname):
                    continue
                violations.append(v)
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations, {"files": len(contexts) + len(errors), "pragmas": honoured}


def lint_file(path: str | Path, config: Config | None = None,
              root: str | Path = ".") -> list[Violation]:
    """Single-file convenience wrapper over :func:`lint_paths`."""
    return lint_paths([path], config=config, root=root)


def capture_contexts(paths: list[str | Path], config: Config | None = None,
                     root: str | Path = ".") -> list[dict]:
    """The capture contexts the linter finds under ``paths``: one dict per
    context with its ``path``, ``qualname``, ``line`` and ``reasons``
    (sorted), sorted by (path, line)."""
    config = config or Config()
    contexts, _ = _project(paths, config, Path(root))
    out = []
    for ctx in contexts:
        for fn, cc in file_capture_contexts(ctx).items():
            out.append({"path": ctx.path, "qualname": ctx.analysis.fn_scopes[fn].qualname,
                        "line": fn.lineno, "reasons": sorted(cc.reasons)})
    return sorted(out, key=lambda c: (c["path"], c["line"], c["qualname"]))
