"""The port's qsqlint rules: QSQ001..QSQ005, one for each rule of the JAX
package's linter, rewritten for what the port does in place of ``jax.jit``
and Pallas (CUDA-graph capture through ``serve/graphs.py::StepGraphs``, and
wrappers that launch hand-written kernels):

* QSQ001 ``no-dense-hot-path`` (JAX QSQ001): packed weights stay packed on
  the serve, model and kernel paths.
* QSQ002 ``capture-host-sync`` (JAX QSQ002 ``tracer-leak``): a capture
  context must not sync the host (``.item()``, ``.cpu()``, ``int()`` of a
  tensor, a data-dependent shape, a Python branch on a tensor,
  ``torch.cuda.synchronize()``): the capture fails, or a replay runs a
  branch taken once at capture.
* QSQ003 ``capture-key-discipline`` (JAX QSQ003 ``static-arg-discipline``):
  a capture key holds every static argument its step threads (a key
  without ``demand`` replays a graph captured at another plane count) and
  nothing that is buffer contents (one capture per value).
* QSQ004 ``plain-only-on-cpu`` (JAX QSQ004 ``kernel-purity``): a CUDA
  tensor runs its kernel or raises.  The plain versions run only behind a
  CPU test, a handler around a build or a launch re-raises, and a branch
  on ``torch.cuda.is_available()`` raises.
* QSQ005 ``trace-time-counters`` (JAX QSQ005): the dispatch counters and
  the kernels' launch and work counters mutate only in their modules'
  designated helpers, never directly in a capture context (a replay runs
  no Python, so the count would freeze after capture; ``StepGraphs``
  records and re-adds counts instead).

A rule is a class with ``id``/``name``/``summary`` and a ``check(ctx)``
generator; ``@register`` adds it to :data:`RULES`.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Iterator

from repro_torch.analysis.astutil import (
    CaptureContext,
    ModuleAnalysis,
    all_args,
    assigned_pairs,
    dotted,
    expr_taints,
    own_nodes,
    static_params_of,
    walk_expr,
)
from repro_torch.analysis.linter import FileContext, Violation, file_capture_contexts

RULES: dict[str, type] = {}


def register(cls):
    RULES[cls.id] = cls
    return cls


class Rule:
    id = "QSQ000"
    name = "abstract"
    summary = ""

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        raise NotImplementedError

    def violation(self, ctx: FileContext, node: ast.AST,
                  message: str) -> Violation:
        return Violation(
            path=ctx.path, line=node.lineno, col=node.col_offset,
            rule=self.id, message=message,
            qualname=ctx.analysis.qualname_of(node),
        )


# --------------------------------------------------------------------------
# QSQ001
# --------------------------------------------------------------------------
@register
class NoDenseHotPath(Rule):
    id = "QSQ001"
    name = "no-dense-hot-path"
    summary = ("dense-materializing calls (as_dense/dequantize/dense_tree) "
               "are forbidden inside serve/, models/, kernels/")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not ctx.config.is_hot_path(ctx.path):
            return
        dense = set(ctx.config.dense_calls)
        for node in ctx.analysis.nodes:
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = None
            if isinstance(func, ast.Attribute) and func.attr in dense:
                name = func.attr
            elif isinstance(func, ast.Name) and func.id in dense:
                name = func.id
            if name is not None:
                yield self.violation(
                    ctx, node,
                    f"`{name}()` materializes a dense weight on a hot path; "
                    f"route packed leaves through `.matmul()`/the dispatch "
                    f"kernels, or pragma with a justification if this path "
                    f"is provably cold",
                )


# --------------------------------------------------------------------------
# QSQ002
# --------------------------------------------------------------------------
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SHAPE_METHODS = frozenset({"nonzero", "unique", "masked_select"})
_SHAPE_CALLS = frozenset({"torch.nonzero", "torch.unique", "torch.masked_select"})
_STATIC_BINDINGS = (ast.Import, ast.ImportFrom, ast.ClassDef, ast.Constant)


def _names_cpu(e: ast.AST, aliases) -> bool:
    if isinstance(e, ast.Constant):
        return isinstance(e.value, str) and e.value.split(":")[0] == "cpu"
    return (isinstance(e, ast.Call) and dotted(e.func, aliases) == "torch.device"
            and bool(e.args) and _names_cpu(e.args[0], aliases))


def _free_inputs(analysis: ModuleAnalysis, fn: ast.AST, statics) -> set[str]:
    """The names a run closure reads from its enclosing scopes that hold
    device values: everything but imports, defs, classes, constants,
    builtins and static parameters of an enclosing function."""
    scope = analysis.fn_scopes[fn]
    out = set()
    for node in own_nodes(fn):
        if (not isinstance(node, ast.Name) or not isinstance(node.ctx, ast.Load)
                or node.id in scope.bindings or node.id in statics):
            continue
        hit = scope.parent.resolve(node.id)
        if hit is None:
            continue  # a builtin, or a global this file does not bind
        bound = hit[1]
        if isinstance(bound, _STATIC_BINDINGS):
            continue
        if isinstance(bound, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            if node.id not in all_args(bound.args):
                continue  # the name of a def
            if node.id in static_params_of(bound, statics):
                continue
        out.add(node.id)
    return out


class _CaptureBodyChecker:
    """Single forward walk over one capture context with a name-level taint
    set: its non-static parameters, a run closure's device inputs, and
    everything derived from them, minus ``.shape``-style static projections."""

    def __init__(self, rule: Rule, ctx: FileContext, cc: CaptureContext):
        self.rule = rule
        self.ctx = ctx
        self.fn = cc.fn
        self.tainted: set[str] = {a for a in all_args(cc.fn.args) if a not in cc.static_names}
        if "run-closure" in cc.reasons:  # a closure's inputs are the buffers it reads
            self.tainted |= _free_inputs(ctx.analysis, cc.fn, set(ctx.config.static_params))
        self.violations: list[Violation] = []

    def run(self) -> list[Violation]:
        if isinstance(self.fn, ast.Lambda):
            self._expr(self.fn.body)
        else:
            self._block(self.fn.body)
        return self.violations

    def _flag(self, node: ast.AST, message: str) -> None:
        self.violations.append(self.rule.violation(self.ctx, node, message))

    # -- statements --------------------------------------------------------
    def _block(self, stmts) -> None:
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # a separate scope
        if isinstance(s, ast.Assign):
            self._expr(s.value)
            taint = expr_taints(s.value, self.tainted)
            for t in s.targets:
                self._assign(t, taint)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value)
                self._assign(s.target, expr_taints(s.value, self.tainted))
        elif isinstance(s, ast.AugAssign):
            self._expr(s.value)
            if isinstance(s.target, ast.Name):
                if expr_taints(s.value, self.tainted):
                    self.tainted.add(s.target.id)
        elif isinstance(s, (ast.If, ast.While)):
            if expr_taints(s.test, self.tainted):
                kind = "if" if isinstance(s, ast.If) else "while"
                self._flag(s, f"Python `{kind}` on a device value inside a captured step: "
                              f"the test syncs the host, and a replay runs the branch taken "
                              f"at capture (use torch.where, or branch on static arguments "
                              f"and shapes)")
            self._expr(s.test)
            self._block(s.body)
            self._block(s.orelse)
        elif isinstance(s, ast.For):
            self._expr(s.iter)
            self._assign(s.target, expr_taints(s.iter, self.tainted))
            self._block(s.body)
            self._block(s.orelse)
        elif isinstance(s, ast.With):
            for item in s.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars,
                                 expr_taints(item.context_expr, self.tainted))
            self._block(s.body)
        elif isinstance(s, ast.Try):
            self._block(s.body)
            for h in s.handlers:
                self._block(h.body)
            self._block(s.orelse)
            self._block(s.finalbody)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    self.tainted.discard(t.id)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self._expr(s.value)
        elif isinstance(s, (ast.Expr, ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(s):
                self._expr(child)

    def _assign(self, target: ast.AST, taint: bool) -> None:
        if isinstance(target, ast.Name):
            if taint:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign(elt, taint)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, taint)

    # -- expressions -------------------------------------------------------
    def _expr(self, e: ast.AST) -> None:
        aliases = self.ctx.analysis.aliases
        for node in walk_expr(e):
            if isinstance(node, ast.NamedExpr):
                self._assign(node.target, expr_taints(node.value, self.tainted))
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            args = [*node.args, *[kw.value for kw in node.keywords]]
            tainted_args = any(expr_taints(a, self.tainted) for a in args)
            method = func.attr if isinstance(func, ast.Attribute) else None
            on_tensor = method is not None and expr_taints(func.value, self.tainted)
            name = dotted(func, aliases)
            if name == "torch.cuda.synchronize" or method == "synchronize":
                self._flag(node, "`synchronize()` inside a captured step: a capture may not "
                                 "wait on the device")
            elif method in _SYNC_METHODS and on_tensor:
                self._flag(node, f"`.{method}()` on a device value copies it to the host "
                                 f"inside a captured step (the capture fails)")
            elif method == "to" and on_tensor and any(_names_cpu(a, aliases) for a in args):
                self._flag(node, "`.to('cpu')` on a device value copies it to the host "
                                 "inside a captured step (the capture fails)")
            elif (isinstance(func, ast.Name) and func.id in ("int", "float", "bool")
                  and func.id not in aliases and tainted_args):
                self._flag(node, f"`{func.id}()` reads a device value as a Python scalar "
                                 f"inside a captured step (a host sync)")
            elif name is not None and name.startswith("numpy.") and tainted_args:
                self._flag(node, f"`{name}` called on a device value inside a captured "
                                 f"step: host numpy syncs and copies it; use torch")
            elif ((name in _SHAPE_CALLS and tainted_args)
                  or (method in _SHAPE_METHODS and on_tensor)):
                self._flag(node, f"`{method or name}` of a device value has a "
                                 f"data-dependent shape: the host must read the count, "
                                 f"which a capture cannot")


@register
class CaptureHostSync(Rule):
    id = "QSQ002"
    name = "capture-host-sync"
    summary = (".item()/.cpu()/int()/np.* on device values, data-dependent shapes, "
               "Python if/while on them and synchronize() inside capture contexts")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for cc in file_capture_contexts(ctx).values():
            yield from _CaptureBodyChecker(self, ctx, cc).run()


# --------------------------------------------------------------------------
# QSQ003
# --------------------------------------------------------------------------
_HOST_READS = frozenset({"item", "tolist"})


def _calls_method(e: ast.AST, methods) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr in methods for n in walk_expr(e))


def _buffer_names(analysis: ModuleAnalysis, site_call: ast.Call, never) -> set[str]:
    """Names in the function around a capture call whose values are buffer
    contents: the ``never_static`` names, names bound from a static buffer's
    ``.put(...)`` or a host read (``.item()``/``.tolist()``), and names
    derived from those (one forward pass in source order)."""
    fn = analysis.enclosing_fn(site_call)
    bad = set(never)
    pairs = []
    for node in (own_nodes(fn) if fn is not None else analysis.nodes):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                pairs.append((node.lineno, t, node.value))
        elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)) and node.value is not None:
            pairs.append((node.lineno, node.target, node.value))
    for _, target, value in sorted(pairs, key=lambda p: p[0]):
        for name, val in assigned_pairs(target, value):
            if (_calls_method(val, {"put"} | _HOST_READS) or expr_taints(val, bad)):
                bad.add(name)
    return bad


@register
class CaptureKeyDiscipline(Rule):
    id = "QSQ003"
    name = "capture-key-discipline"
    summary = ("a capture key holds every demand/drop-style argument its step threads, "
               "and no buffer contents (tiers/active/plane_mask, .put() results, host reads)")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        must = set(ctx.config.static_params)
        analysis = ctx.analysis
        for site in analysis.capture_sites:
            at = site.key if site.key is not None else site.call
            key_names = ({n.id for n in walk_expr(site.key) if isinstance(n, ast.Name)}
                         if site.key is not None else set())
            # (a) every static argument the step passes on is in the key
            if site.closure is not None:
                scope = analysis.fn_scopes[site.closure]
                passed = {n.id for n in own_nodes(site.closure)
                          if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                          and n.id in must and n.id not in scope.bindings}
                missing = sorted(passed - key_names)
                if missing:
                    yield self.violation(
                        ctx, at,
                        f"the captured step threads {missing} but its capture key does not "
                        f"hold them: a call at another value replays the graph captured "
                        f"at the first")
            # (b) the key is made of static arguments only
            if site.key is None:
                continue
            bad = _buffer_names(analysis, site.call, ctx.config.never_static)
            culprits = sorted(n for n in key_names if n in bad and expr_taints(
                site.key, {n}))
            if culprits or _calls_method(site.key, _HOST_READS):
                what = culprits or [".item()/.tolist()"]
                yield self.violation(
                    ctx, at,
                    f"capture key depends on buffer contents {what}: tiers, masks, "
                    f"slots and token values are copied into static buffers, and a key "
                    f"on them captures once per value")


# --------------------------------------------------------------------------
# QSQ004
# --------------------------------------------------------------------------
#: calls that build or launch a kernel (patterns on the canonical name): a
#: handler around them must re-raise
LAUNCH_CALLS = ("repro_torch.kernels.build.load", "repro_torch.kernels.build.build",
                "repro_torch.kernels.qsq._launch", "subprocess.*")
#: where a branch on ``torch.cuda.is_available()`` must raise: the package
PORT_PATH = "src/repro_torch/"


def _is_cpu_test(test: ast.AST, ctx: FileContext) -> bool:
    """``_on_cpu(...)``, ``<x>.device.type == "cpu"``, or an ``and`` of
    which one part is such a test."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_is_cpu_test(v, ctx) for v in test.values)
    if isinstance(test, ast.Call):
        name = dotted(test.func, ctx.analysis.aliases)
        return name is not None and name.rsplit(".", 1)[-1] in ctx.config.cpu_guards
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        sides = (test.left, test.comparators[0])
        return (any(isinstance(s, ast.Attribute) and s.attr == "type" for s in sides)
                and any(isinstance(s, ast.Constant) and s.value == "cpu" for s in sides))
    return False


def _raises(stmts) -> bool:
    for s in stmts:
        if isinstance(s, ast.Raise):
            return True
        if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = [c for c in ast.iter_child_nodes(s) if isinstance(c, ast.stmt)]
            if body and _raises(body):
                return True
    return False


@register
class PlainOnlyOnCpu(Rule):
    id = "QSQ004"
    name = "plain-only-on-cpu"
    summary = ("a CUDA tensor runs its kernel or raises: plain versions only behind a "
               "CPU test, handlers around builds/launches re-raise, a branch on "
               "torch.cuda.is_available() raises")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if ctx.config.is_kernel_module(ctx.path):
            yield from self._plain_calls(ctx)
            yield from self._handlers(ctx)
        if ctx.path.startswith(PORT_PATH):
            yield from self._availability(ctx)

    # (a) a call into the plain versions lies in the body of a CPU test
    def _plain_calls(self, ctx) -> Iterator[Violation]:
        analysis = ctx.analysis
        for node in ctx.analysis.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = analysis.canonical(node.func)
            if name is None or not ctx.config.is_plain(name):
                continue
            if not self._guarded(ctx, node):
                yield self.violation(
                    ctx, node,
                    f"`{name}` (a plain version) is reachable off the CPU: call it only "
                    f"in the body of `if _on_cpu(...)` (or `.device.type == \"cpu\"`); a "
                    f"CUDA tensor runs its kernel or raises")

    @staticmethod
    def _guarded(ctx, node) -> bool:
        analysis = ctx.analysis
        child, cur = node, analysis.parent_map.get(node)
        while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                       ast.Lambda)):
            if isinstance(cur, ast.If) and child in cur.body and _is_cpu_test(cur.test, ctx):
                return True
            if isinstance(cur, ast.IfExp) and child is cur.body and _is_cpu_test(cur.test, ctx):
                return True
            child, cur = cur, analysis.parent_map.get(cur)
        return False

    # (b) a handler around a build or a launch re-raises
    def _handlers(self, ctx) -> Iterator[Violation]:
        analysis = ctx.analysis
        for node in ctx.analysis.nodes:
            if not isinstance(node, ast.Try):
                continue
            launches = sorted({name for s in node.body for n in walk_expr(s)
                               if isinstance(n, ast.Call)
                               and (name := analysis.canonical(n.func)) is not None
                               and any(fnmatch.fnmatchcase(name, p) for p in LAUNCH_CALLS)})
            if not launches:
                continue
            for h in node.handlers:
                if not _raises(h.body):
                    yield self.violation(
                        ctx, h,
                        f"handler around {launches} does not re-raise: a failed build "
                        f"or launch on a CUDA tensor must raise, not fall back")

    # (c) a branch on torch.cuda.is_available() raises
    def _availability(self, ctx) -> Iterator[Violation]:
        aliases = ctx.analysis.aliases
        for node in ctx.analysis.nodes:
            if not isinstance(node, (ast.If, ast.IfExp)):
                continue
            if not any(isinstance(n, ast.Call)
                       and dotted(n.func, aliases) == "torch.cuda.is_available"
                       for n in walk_expr(node.test)):
                continue
            if isinstance(node, ast.IfExp) or not _raises(node.body):
                yield self.violation(
                    ctx, node,
                    "a branch on `torch.cuda.is_available()` must raise: choosing the "
                    "CPU when CUDA is missing runs the plain versions where a kernel "
                    "was asked for")


# --------------------------------------------------------------------------
# QSQ005
# --------------------------------------------------------------------------
@register
class TraceTimeCounters(Rule):
    id = "QSQ005"
    name = "trace-time-counters"
    summary = ("dispatch.counters/traffic and qsq.launches/work mutate only in their "
               "modules' designated helpers, never directly in a capture context")

    MUTATORS = frozenset({"clear", "update", "subtract", "pop", "popitem",
                          "setdefault", "__setitem__", "__delitem__"})

    def _is_counter(self, node: ast.AST, analysis: ModuleAnalysis,
                    objects: set[str]) -> bool:
        name = analysis.canonical(node)
        return name is not None and name in objects

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        analysis = ctx.analysis
        objects = set(ctx.config.counter_objects)
        captured = set(file_capture_contexts(ctx))

        def flag(node, what: str):
            if analysis.enclosing_fn(node) in captured:
                return self.violation(
                    ctx, node,
                    f"{what} inside a captured step: a replay runs no Python, so the "
                    f"count would stop at the capture (StepGraphs records a step's "
                    f"counts and re-adds them on every replay)")
            if ctx.config.counter_scope_allowed(ctx.path, analysis.qualname_of(node)):
                return None
            return self.violation(
                ctx, node,
                f"{what} outside the designated counter helpers "
                f"(allowed scopes: config `counter_scopes`); tests that "
                f"deliberately seed counters need a pragma + justification")

        for node in ctx.analysis.nodes:
            v = None
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if self._is_counter(base, analysis, objects):
                        v = flag(node, "counter mutation")
                        break
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if self._is_counter(base, analysis, objects):
                        v = flag(node, "counter deletion")
                        break
            elif isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in self.MUTATORS
                        and self._is_counter(func.value, analysis, objects)):
                    v = flag(node, f"counter `.{func.attr}()`")
            if v is not None:
                yield v
