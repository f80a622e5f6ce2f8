"""Seeded weights made on the device in a few large draws.

A family's reference gives its weight ``layout``: a list of leaves
``(path, shape, init, arg)``, ``path`` a tuple of dict keys and list
indices (``("blocks", 0, "wq")``).  ``init`` is ``"normal"`` (N(0,
arg²)), ``"zeros"``, ``"ones"``, ``"log_uniform"`` (log of U[lo, hi],
``arg`` = (lo, hi): Mamba-2's ``A_log``) or ``"dt_bias"`` (the inverse
softplus of exp(U[log lo, log hi]), ``arg`` = (lo, hi): Mamba-2's
``dt_bias``).  ``make`` draws every normal leaf from one ``torch.randn``
of their total size with a generator on the device seeded from the
run's seed, and scales each leaf's view of it in place; the few uniform
leaves follow from the same generator.  The same seed gives the same
weights in any process.  Both the program and the reference are given
weights made this way; the reference's are made again after the
program's state is freed.
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

Leaf = Tuple[tuple, Tuple[int, ...], str, Any]


def tree_set(tree: dict, path: tuple, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def tree_get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def make(torch, layout: List[Leaf], seed: int, device, dtype=None) -> Any:
    dtype = dtype or torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, init, _ in layout
                if init == "normal")
    draw = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    off = 0
    for path, shape, init, arg in layout:
        n = math.prod(shape)
        if init == "normal":
            leaf = draw[off:off + n].view(shape).mul_(arg)
            off += n
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif init in ("log_uniform", "dt_bias"):
            lo, hi = arg
            u = torch.rand(shape, generator=gen, dtype=torch.float64,
                           device=device)
            if init == "log_uniform":
                leaf = torch.log(lo + (hi - lo) * u)
            else:
                dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                               * u).clamp(min=1e-4)
                leaf = dt + torch.log(-torch.expm1(-dt))
            leaf = leaf.to(dtype)
        else:
            raise ValueError(f"unknown init {init!r} for {path}")
        tree_set(tree, path, leaf)
    return tree


def count(layout: List[Leaf]) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout)
