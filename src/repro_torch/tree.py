"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

Parameters, optimizer state and checkpoints are nested dicts whose leaves
are tensors (or anything else that is not a dict). Leaves are visited in
sorted key order, the order ``jax.tree.leaves`` gives a dict, and named by
their ``/``-joined key path (the reference checkpoint's leaf names).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["leaves", "flatten_with_paths", "tree_map", "unflatten"]


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` in sorted key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix
                                      else str(k)))
    return out


def leaves(tree) -> List[Any]:
    return list(flatten_with_paths(tree).values())


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (which may hold a dict where ``tree`` holds a leaf, as the
    factored second moment does beside its parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    """The tree shaped as ``template`` with the leaves of ``flat`` (keys as
    :func:`flatten_with_paths` names them)."""
    if not isinstance(template, dict):
        return flat[prefix]
    return {k: unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template.items()}
