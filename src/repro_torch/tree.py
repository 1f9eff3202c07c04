"""Nested-dict parameter trees: the reference's pytree layout, in torch.

Leaves are tensors (or numpy arrays on the host); ``None`` leaves pass
through. Only what the port needs: a map over one or more trees of the
same structure, and indexing / stacking along a leading axis.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees that share ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_index(tree: Any, i: int) -> Any:
    """Leaf-wise ``leaf[i]`` (a view for tensors)."""
    return tree_map(lambda t: t[i], tree)


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-structured trees along a new leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)
