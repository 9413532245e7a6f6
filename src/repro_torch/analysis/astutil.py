"""AST groundwork shared by the port's qsqlint rules.

One :class:`ModuleAnalysis` is built per file and answers the questions
every rule asks:

* alias resolution: ``F.linear`` -> ``torch.nn.functional.linear`` via the
  module's imports, so rules match canonical dotted names, not spelling;
* scopes: a binding tree (module / function / lambda) with name resolution
  up the enclosing chain, and qualnames as Python spells them
  (``ServeEngine._decode_call.<lambda>``, without ``<locals>``);
* factories: module-level defs that return a local def or a lambda (the
  step builders of ``train/step.py``), with their products;
* capture sites: calls of a capture method (``StepGraphs.run``) and the
  step closure each one captures, found once the project index knows
  which attributes hold a capture object (``self.graphs = StepGraphs(...)``).

The *capture contexts* (the port's counterpart of the JAX linter's jit
contexts) are the bodies that run under CUDA-graph capture, or that the JAX
package jits: (a) the step closure of every capture call, (b) the products
of the step factories of ``step_factory_modules``, and (c) the product of
a factory that a run closure reaches as ``self.<attr>(...)`` where its
class bound ``self.<attr> = <factory>(...)``.

Everything here is deliberately flow-light: a single forward walk per
function, no fixpoints, callees not followed.
"""
from __future__ import annotations

import ast
import dataclasses

#: attribute names whose access on a tensor yields a STATIC value: a Python
#: branch on these is shape logic, not a host sync.
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "sharding", "device", "is_cuda",
                          "layout"})

#: tensor methods whose result is static (metadata, no device read).
STATIC_METHODS = frozenset({"size", "dim", "numel", "element_size", "is_contiguous"})

#: calls that collapse an operand to a static value (len(x) is x.shape[0];
#: isinstance/type dispatch on the object itself).
STATIC_CALLS = frozenset({"len", "isinstance", "type", "getattr", "hasattr"})

#: a parameter annotated with one of these is a static argument.
SCALAR_ANNOTATIONS = frozenset({"int", "float", "bool", "str"})

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


# --------------------------------------------------------------------------
# Aliases
# --------------------------------------------------------------------------
def build_aliases(tree: ast.Module, nodes=None) -> dict[str, str]:
    """Map local names to canonical dotted paths from the module's imports
    (``nodes``: the tree's nodes, when the caller has them already)."""
    aliases: dict[str, str] = {}
    for node in (ast.walk(tree) if nodes is None else nodes):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Canonical dotted path of a Name/Attribute chain, alias-expanded."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


# --------------------------------------------------------------------------
# Scopes
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Scope:
    node: ast.AST  # Module | FunctionDef | AsyncFunctionDef | Lambda
    parent: "Scope | None"
    qualname: str
    bindings: dict[str, ast.AST] = dataclasses.field(default_factory=dict)

    def resolve(self, name: str) -> "tuple[Scope, ast.AST] | None":
        scope: Scope | None = self
        while scope is not None:
            if name in scope.bindings:
                return scope, scope.bindings[name]
            scope = scope.parent
        return None


def _bind_target(scope: Scope, target: ast.AST, value: ast.AST) -> None:
    if isinstance(target, ast.Name):
        scope.bindings[target.id] = value
    elif isinstance(target, (ast.Tuple, ast.List)):
        if (isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts)
                and not any(isinstance(e, ast.Starred) for e in target.elts)):
            for elt, val in zip(target.elts, value.elts, strict=True):
                _bind_target(scope, elt, val)
        else:
            for elt in target.elts:
                _bind_target(scope, elt, value)
    elif isinstance(target, ast.Starred):
        _bind_target(scope, target.value, value)


def assigned_pairs(target: ast.AST, value: ast.AST):
    """(name, value) pairs of one assignment, element-wise where a tuple is
    assigned from a tuple of the same length."""
    scope = Scope(target, None, "")
    _bind_target(scope, target, value)
    return scope.bindings.items()


class _ScopeBuilder(ast.NodeVisitor):
    """Build the scope tree; record the scope owning every function def."""

    def __init__(self, tree: ast.Module):
        self.module_scope = Scope(tree, None, "<module>")
        self.fn_scopes: dict[ast.AST, Scope] = {}
        self.fn_parent: dict[ast.AST, Scope] = {}
        self._stack = [self.module_scope]
        self._classes: list[list[str]] = [[]]  # class names open in each scope
        self.returns: dict[ast.AST, list[ast.Return]] = {}  # def -> its own returns
        self.visit(tree)

    @property
    def _cur(self) -> Scope:
        return self._stack[-1]

    def _qual(self, name: str) -> str:
        parts = [] if self._cur.qualname == "<module>" else [self._cur.qualname]
        return ".".join([*parts, *self._classes[-1], name])

    def _enter(self, node, qual: str, body) -> None:
        scope = Scope(node, self._cur, qual)
        for arg in all_args(node.args):
            scope.bindings[arg] = node
        self.fn_scopes[node] = scope
        self._stack.append(scope)
        self._classes.append([])
        for stmt in body:
            self.visit(stmt)
        self._classes.pop()
        self._stack.pop()

    def _visit_function(self, node):
        self.fn_parent[node] = self._cur
        self._cur.bindings[node.name] = node
        for d in [*node.decorator_list, *node.args.defaults, *node.args.kw_defaults]:
            if d is not None:
                self.visit(d)
        self._enter(node, self._qual(node.name), node.body)

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Lambda(self, node: ast.Lambda):
        self.fn_parent[node] = self._cur
        for d in [*node.args.defaults, *node.args.kw_defaults]:
            if d is not None:
                self.visit(d)
        self._enter(node, self._qual("<lambda>"), [node.body])

    def visit_ClassDef(self, node: ast.ClassDef):
        self._cur.bindings[node.name] = node
        # class bodies are not enclosing scopes for the methods inside them
        # (name resolution skips them); they do name the methods' qualnames
        self._classes[-1].append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self._classes[-1].pop()

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            _bind_target(self._cur, t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            _bind_target(self._cur, node.target, node.value)
        self.generic_visit(node)

    def visit_NamedExpr(self, node: ast.NamedExpr):
        _bind_target(self._cur, node.target, node.value)
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        _bind_target(self._cur, node.target, node.iter)
        self.generic_visit(node)

    def visit_With(self, node: ast.With):
        for item in node.items:
            if item.optional_vars is not None:
                _bind_target(self._cur, item.optional_vars, item.context_expr)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension):
        _bind_target(self._cur, node.target, node.iter)
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return):
        self.returns.setdefault(self._cur.node, []).append(node)
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self._cur.bindings[a.asname or a.name.split(".")[0]] = node

    def visit_ImportFrom(self, node: ast.ImportFrom):
        for a in node.names:
            if a.name != "*":
                self._cur.bindings[a.asname or a.name] = node


def all_args(args: ast.arguments) -> list[str]:
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _scalar_annotation(ann: ast.AST | None) -> bool:
    """``int``/``float``/``bool``/``str``, alone or ``| None``."""
    if isinstance(ann, ast.Name):
        return ann.id in SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.replace(" ", "").removesuffix("|None") in SCALAR_ANNOTATIONS
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        sides = (ann.left, ann.right)
        return (any(_scalar_annotation(s) for s in sides)
                and all(_scalar_annotation(s) or (isinstance(s, ast.Constant)
                                                  and s.value is None) for s in sides))
    return False


def static_params_of(fn: ast.AST, static_names) -> frozenset[str]:
    """Parameters of ``fn`` that are static: named in ``static_names`` or
    annotated with a scalar type."""
    a = fn.args
    out = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
           if x.arg in static_names or _scalar_annotation(x.annotation)}
    return frozenset(out)


def own_nodes(fn: ast.AST):
    """Nodes of ``fn``'s own body, not descending into nested defs, lambdas
    or classes (their bodies are separate scopes)."""
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    stack = [n for n in body if not isinstance(n, (*_SCOPES, ast.ClassDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (*_SCOPES, ast.ClassDef)):
                stack.append(child)


# --------------------------------------------------------------------------
# Factories, capture sites, capture contexts
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FactoryInfo:
    """A module-level def that returns a locally defined function or a
    lambda (a step factory)."""

    module: str  # dotted module path, e.g. "repro_torch.train.step"
    name: str
    products: list[ast.AST]  # the returned FunctionDef / Lambda nodes


@dataclasses.dataclass
class CaptureSite:
    """``<capture object>.run(key, fn, ...)``: ``closure`` is the def or
    lambda ``fn`` names (None when it is not resolvable)."""

    call: ast.Call
    key: ast.AST | None
    closure: ast.AST | None


@dataclasses.dataclass
class CaptureContext:
    fn: ast.AST  # FunctionDef | Lambda
    static_names: frozenset[str]
    reasons: set[str]  # "run-closure" | "factory-product" | "resolved"


class ModuleAnalysis:
    """Everything the rules need to know about one parsed module."""

    def __init__(self, tree: ast.Module, path: str, module: str,
                 capture_classes: dict[str, str] | None = None):
        self.tree = tree
        self.path = path
        self.module = module
        self.capture_classes = dict(capture_classes or {})  # class -> capture method
        # every node once (the rules iterate this, not ast.walk), and its parent
        self.nodes: list[ast.AST] = []
        self.parent_map: dict[ast.AST, ast.AST] = {}
        stack: list[ast.AST] = [tree]
        while stack:
            node = stack.pop()
            self.nodes.append(node)
            for child in ast.iter_child_nodes(node):
                self.parent_map[child] = node
                stack.append(child)
        self.aliases = build_aliases(tree, self.nodes)
        builder = _ScopeBuilder(tree)
        self.module_scope = builder.module_scope
        self.fn_scopes = builder.fn_scopes
        self.fn_parent = builder.fn_parent
        self._returns = builder.returns

        self.factories: dict[str, FactoryInfo] = {}
        # attributes assigned a capture object anywhere in this module
        self.capture_attrs: set[str] = set()
        # (class name, attribute) -> canonical name of the factory whose
        # product ``self.<attribute>`` holds
        self.attr_factories: dict[tuple[str, str], str] = {}
        self.capture_sites: list[CaptureSite] = []  # filled by ProjectIndex.finish
        self._collect_factories()
        self._collect_attrs()

    # -- helpers -----------------------------------------------------------
    def qualname_of(self, node: ast.AST) -> str:
        """Qualified name of the function scope enclosing ``node``."""
        cur = node
        while cur is not None:
            if cur in self.fn_scopes:
                return self.fn_scopes[cur].qualname
            cur = self.parent_map.get(cur)
        return "<module>"

    def enclosing_fn(self, node: ast.AST) -> ast.AST | None:
        """The innermost def or lambda around ``node`` (not ``node`` itself)."""
        cur = self.parent_map.get(node)
        while cur is not None:
            if cur in self.fn_scopes:
                return cur
            cur = self.parent_map.get(cur)
        return None

    def enclosing_scope(self, node: ast.AST) -> Scope:
        fn = self.enclosing_fn(node)
        return self.module_scope if fn is None else self.fn_scopes[fn]

    def resolve_def(self, name: str, at: ast.AST):
        """Resolve ``name`` to a FunctionDef through the scope chain."""
        hit = self.enclosing_scope(at).resolve(name)
        if hit is None:
            return None
        _, bound = hit
        return bound if isinstance(bound, _FUNCS) else None

    def canonical(self, node: ast.AST) -> str | None:
        """Dotted path of an expression, module-qualified when local."""
        name = dotted(node, self.aliases)
        if name is None:
            return None
        if "." not in name and name not in self.aliases:
            return f"{self.module}.{name}"
        return name

    def _is_capture_ctor(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = dotted(node.func, self.aliases)
        return name is not None and name.rsplit(".", 1)[-1] in self.capture_classes

    def method_class(self, fn: ast.AST) -> tuple[str, ast.AST] | None:
        """(class name, method def) of the method enclosing ``fn`` (or
        ``fn`` itself)."""
        cur = fn
        while cur is not None:
            parent = self.parent_map.get(cur)
            if isinstance(cur, _FUNCS) and isinstance(parent, ast.ClassDef):
                return parent.name, cur
            cur = parent
        return None

    # -- collection passes -------------------------------------------------
    def _collect_factories(self) -> None:
        for fn, scope in self.fn_scopes.items():
            if isinstance(fn, ast.Lambda) or self.fn_parent[fn] is not self.module_scope:
                continue
            products = []
            for node in self._returns.get(fn, ()):
                if isinstance(node.value, ast.Lambda):
                    products.append(node.value)
                elif isinstance(node.value, ast.Name):
                    bound = scope.bindings.get(node.value.id)
                    if isinstance(bound, _FUNCS) and self.fn_parent.get(bound) is scope:
                        products.append(bound)
            if products:
                products.sort(key=lambda n: (n.lineno, n.col_offset))
                self.factories[fn.name] = FactoryInfo(self.module, fn.name, products)

    def _collect_attrs(self) -> None:
        for node in self.nodes:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if not isinstance(t, ast.Attribute):
                    continue
                if self._is_capture_ctor(value):
                    self.capture_attrs.add(t.attr)
                owner = self.method_class(node)
                if (owner is not None and isinstance(value, ast.Call)
                        and isinstance(t.value, ast.Name) and owner[1].args.args
                        and t.value.id == owner[1].args.args[0].arg):
                    callee = self.canonical(value.func)
                    if callee is not None:
                        self.attr_factories[(owner[0], t.attr)] = callee

    def find_capture_sites(self, capture_attrs: set[str]) -> None:
        """Every capture call of this module; ``capture_attrs`` are the
        attribute names that hold a capture object anywhere in the project."""
        self.capture_sites = []
        for node in self.nodes:
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            recv, method = node.func.value, node.func.attr
            if method not in self.capture_classes.values():
                continue
            if isinstance(recv, ast.Name):
                hit = self.enclosing_scope(node).resolve(recv.id)
                recv = hit[1] if hit is not None else recv
            if not (self._is_capture_ctor(recv)
                    or (isinstance(recv, ast.Attribute) and recv.attr in capture_attrs)):
                continue
            args = {kw.arg: kw.value for kw in node.keywords}
            key = node.args[0] if node.args else args.get("key")
            fn = node.args[1] if len(node.args) > 1 else args.get("fn")
            closure = None
            if isinstance(fn, ast.Lambda):
                closure = fn
            elif isinstance(fn, ast.Name):
                closure = self.resolve_def(fn.id, node)
            self.capture_sites.append(CaptureSite(node, key, closure))

    def resolved_factories(self) -> set[str]:
        """Canonical names of the factories whose products a run closure of
        this module calls as ``self.<attr>(...)``: (c) of the module doc."""
        out = set()
        for site in self.capture_sites:
            if site.closure is None:
                continue
            owner = self.method_class(site.closure)
            if owner is None or not owner[1].args.args:
                continue
            self_name = owner[1].args.args[0].arg
            for node in own_nodes(site.closure):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == self_name):
                    factory = self.attr_factories.get((owner[0], node.func.attr))
                    if factory is not None:
                        out.add(factory)
        return out


# --------------------------------------------------------------------------
# Taint: does an expression depend on a device value?
# --------------------------------------------------------------------------
def expr_taints(node: ast.AST, tainted: set[str]) -> bool:
    """True if ``node``'s value can depend on a tensor named in ``tainted``.

    Access through a STATIC_ATTRS attribute (``x.shape``, ``x.device`` and
    friends), a STATIC_METHODS call (``x.numel()``) and identity-vs-None
    comparisons are static and do not propagate taint; neither do
    STATIC_CALLS.  Function/lambda bodies are opaque (their names don't leak
    taint by reference).
    """
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return False
        return expr_taints(node.value, tainted)
    if isinstance(node, ast.Subscript):
        return (expr_taints(node.value, tainted)
                or expr_taints(node.slice, tainted))
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            operands = [node.left, *node.comparators]
            if any(isinstance(o, ast.Constant) and o.value is None
                   for o in operands):
                return False
        return any(expr_taints(o, tainted)
                   for o in [node.left, *node.comparators])
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in STATIC_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) and node.func.attr in STATIC_METHODS:
            return False
        parts = [node.func, *node.args, *[kw.value for kw in node.keywords]]
        return any(expr_taints(p, tainted) for p in parts)
    if isinstance(node, _SCOPES):
        return False
    return any(expr_taints(child, tainted)
               for child in ast.iter_child_nodes(node))


def walk_expr(node: ast.AST):
    """Yield ``node`` and descendants, not descending into nested
    function/lambda bodies (they are separate scopes)."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, _SCOPES):
            continue
        yield from walk_expr(child)
