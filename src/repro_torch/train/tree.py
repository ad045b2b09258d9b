"""Nested dicts of tensors as the reference's pytrees: leaves in JAX's
order (dict keys sorted, sequences in order) and their ``/``-joined paths
(the keys ``repro.train.checkpoint`` writes)."""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_paths"]


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        kids = (tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree))
        if hasattr(tree, "_fields"):         # a named tuple
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in JAX's flatten order; paths join the keys with
    ``/`` (``params/seg0/attn/wq``, ``opt/step``)."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from tree_paths(v, f"{prefix}/{k}" if prefix else k)


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in tree_paths(tree)]
