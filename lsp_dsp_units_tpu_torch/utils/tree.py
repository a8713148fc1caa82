"""State trees: the port's counterpart of the ``jax.tree_util`` walk that
the JAX package's state helpers rely on.

A tree is built of NamedTuples (children by field name), tuples and lists
(by index) and dicts (by sorted key); ``None`` has no children and so no
leaf, as in ``jax.tree_util``; everything else (a tensor, a numpy array, a
Python number) is a leaf.  Paths are the JAX package's strings
(``utils/state._path_str``): the parts joined by ``/``, e.g.
``fdl/spec_re`` or ``comp/knees/0/start``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    """(name, child) pairs of a node; an empty list for a leaf or None."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return []


def is_leaf(tree) -> bool:
    return tree is not None and not isinstance(tree, (tuple, list, dict))


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf of ``tree`` with its path, in flattening order."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += leaves_with_path(child, f"{prefix}/{name}" if prefix else name)
    return out


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, the leaves
    visited in :func:`leaves_with_path`'s order."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
