"""Nested containers of tensors (the port's counterpart of JAX pytrees):
dicts, lists, tuples and NamedTuples, with tensors or other values at the
leaves.  The optimizer maps over parameter trees with these, and the
checkpoint names each leaf by its path."""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order: dict keys in insertion order,
    list and tuple items by index, NamedTuple fields by name; paths are
    "/"-joined.  ``None`` is no leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(tree_like, values: list):
    """A tree of ``tree_like``'s structure whose leaves are ``values``, in
    ``leaves_with_paths`` order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree_like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
