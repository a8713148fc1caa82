"""State trees: the port's counterpart of the ``jax.tree_util`` walk that
the JAX package's state helpers rely on.

A tree is built of NamedTuples (children by field name), tuples and lists
(by index) and dicts (by sorted key); ``None`` has no children and so no
leaf, as in ``jax.tree_util``; everything else (a tensor, a numpy array, a
Python number) is a leaf.  Paths are the JAX package's strings
(``utils/state._path_str``): the parts joined by ``/``, e.g.
``fdl/spec_re`` or ``comp/knees/0/start``.  :func:`tree_flatten` and
:func:`tree_unflatten` walk the leaves in that order, which is
``jax.tree_util.tree_flatten``'s, so a JAX tree's flat leaves rebuild the
port's tree of the same shape.
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


class _Leaf:
    """The place of a leaf in a tree's skeleton."""

    def __repr__(self):
        return "*"


_LEAF = _Leaf()


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in :func:`leaves_with_path`'s order, the tree's skeleton),
    as ``jax.tree_util.tree_flatten`` returns them."""
    return ([v for _, v in leaves_with_path(tree)],
            tree_map(lambda _: _LEAF, tree))


def tree_unflatten(skeleton, leaves) -> Any:
    """The tree of ``skeleton`` (from :func:`tree_flatten`) with
    ``leaves`` in its places, in order."""
    it = iter(leaves)
    try:
        tree = tree_map(lambda _: next(it), skeleton)
    except StopIteration:
        raise ValueError("fewer leaves than the tree has places") from None
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree has places")
    return tree
