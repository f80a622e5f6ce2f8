"""Small tree utilities over nested dicts, lists and tuples of tensors
(the port of the reference's ``utils/tree.py``).

Leaves come in the reference's order, that of ``jax.tree.leaves``: a
dict's entries by sorted key, a list's or tuple's in order, depth first.
``tree_flatten`` also gives each leaf's path in the reference's
``jax.tree_util.keystr`` form (``['blocks'][0]['wq']``), which the
checkpoint store writes as the leaf's name.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's leaf order; None is no leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_cast(tree, dtype):
    return tree_map(lambda a: a.to(dtype), tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda a: torch.zeros(a.shape, dtype=dtype or a.dtype,
                                          device=a.device), tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda a: a * s, tree)


def global_sq_norm(tree):
    """The sum of the leaves' squares, each leaf summed in float32, the
    leaf sums added in leaf order from 0 (Python's ``sum``, as the
    reference)."""
    return sum(torch.sum(torch.square(leaf.float()))
               for leaf in tree_leaves(tree))


def tree_size(tree) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree))
