"""Minimal nested-container helpers for parameter trees.

The JAX package walks its parameter trees with ``jax.tree_util``; the port
keeps the same nested shape (dicts, lists, tuples, NamedTuples) and walks
it with these few functions.  Dict keys are visited in sorted order, as
``jax.tree_util`` flattens them, so leaf orders and '/'-joined paths agree
between the two packages.  ``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


class FieldKey(str):
    """A NamedTuple field in a key path: equal to its name as a ``str``
    (so paths still index dicts and join with '/'), but :func:`keystr`
    writes it ``.name`` as ``jax.tree_util.keystr`` writes a GetAttrKey."""


def _children(node):
    """(keys, children, rebuild) for a container node, else None."""
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if _is_namedtuple(node):
        keys = [FieldKey(f) for f in node._fields]
        return keys, list(node), lambda vals: type(node)(*vals)
    if isinstance(node, (list, tuple)):
        keys = list(range(len(node)))
        return keys, list(node), lambda vals: type(node)(vals)
    return None


def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None, path=()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over every leaf; path is a key tuple."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    kids = _children(tree)
    if kids is None:
        return fn(path, tree, *rest)
    keys, vals, rebuild = kids
    rest_vals = []
    for r in rest:
        rk = _children(r)
        if rk is None:
            raise ValueError(f"tree structure mismatch at {path_str(path)!r}")
        rest_vals.append(dict(zip(rk[0], rk[1])))
    out = [
        tree_map_with_path(fn, v, *(rv[k] for rv in rest_vals),
                           is_leaf=is_leaf, path=path + (k,))
        for k, v in zip(keys, vals, strict=True)
    ]
    return rebuild(out)


def tree_map(fn: Callable, tree, *rest, is_leaf=None) -> Any:
    return tree_map_with_path(lambda _, *a: fn(*a), tree, *rest, is_leaf=is_leaf)


def tree_leaves_with_path(tree, is_leaf=None, path=()) -> list[tuple[tuple, Any]]:
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, v in zip(kids[0], kids[1], strict=True):
        out.extend(tree_leaves_with_path(v, is_leaf, path + (k,)))
    return out


def tree_leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def path_str(path) -> str:
    """Key tuple -> 'a/b/0/c', the JAX package's ``path_str`` form."""
    return "/".join(str(k) for k in path)


def _key(k) -> str:
    if isinstance(k, FieldKey):
        return f".{k}"
    return f"[{k!r}]" if isinstance(k, str) else f"[{k}]"


def keystr(path) -> str:
    """Key tuple -> ".opt.m['a'][0]", ``jax.tree_util.keystr``'s form (the
    npz keys both packages write): NamedTuple fields as ``.field``, dict
    keys as ``['key']``, sequence indices as ``[i]``."""
    return "".join(_key(k) for k in path)
