"""The port's parameter trees: nested dicts, with a list of per-layer dicts
for each layer stack (``models/model.py``), and tensor leaves.  An int8
moment ``{"q", "s"}`` (``adamw.quantize_q8``) is one leaf of an optimizer
state's tree.  Leaves come in insertion order, depth first."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, (dict, list, tuple)) or is_q8(x)


def is_q8(x: Any) -> bool:
    """An int8 moment: a dict of exactly ``q`` and ``s``."""
    return isinstance(x, dict) and set(x) == {"q", "s"}


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order."""
    if _is_leaf(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in vals for leaf in tree_leaves(v)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of the leaves of ``tree`` and the matching leaves (or
    subtrees) of each of ``rest``, in ``tree``'s structure."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)
    in place of its own."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
