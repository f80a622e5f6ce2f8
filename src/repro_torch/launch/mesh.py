"""Meshes over the ranks of a ``torch.distributed`` process group (the
part of the reference's ``launch/mesh.py`` that ``launch/train.py``
needs: ``make_host_mesh``).

A mesh lays the world's ranks out row-major over named axes, as a JAX
mesh lays out its devices: with axes ``("pod", "data")`` of sizes
(2, 4), rank ``r`` sits at ``pod = r // 4``, ``data = r % 4``.  It
gives each axis's size (``shape``), this rank's index on an axis
(``axis_index``) and, for any tuple of axes, the process group of the
ranks that share this rank's indices on the other axes (``group``), the
group a collective over those axes runs in.  Building a mesh is
collective: every rank must build the same mesh, in the same order as
any other group it makes, since each subgroup is a ``new_group`` call on
every rank.

``with mesh:`` makes a mesh the current one, which the collectives of
``regc_sync.policies`` use when they are not given one (as a reference
collective names its axes inside ``shard_map``).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


class Mesh:
    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ")
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialised process group "
                               "(repro_torch.launch.ranks.init_world)")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} holds "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{world}")
        self.axes = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.rank = dist.get_rank()
        self._coords = dict(zip(axes, _unravel(self.rank, shape)))
        self._groups: Dict[Tuple[str, ...], tuple] = {}
        for r in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, r):
                others = [a for a in axes if a not in sub]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    at = dict(zip(others, fixed))
                    ranks = [self._rank_at({**at, **dict(zip(sub, c))})
                             for c in itertools.product(
                                 *(range(self.shape[a]) for a in sub))]
                    group = (None if len(ranks) == world
                             else dist.new_group(ranks))
                    if self.rank in ranks:
                        self._groups[sub] = (group, ranks)

    def _rank_at(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axes:
            r = r * self.shape[a] + coords[a]
        return r

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or not axes:
            raise ValueError(f"axes {axes} not of the mesh {self.shape}")
        return tuple(a for a in self.axes if a in axes)

    def group(self, axes) -> "tuple[Optional[dist.ProcessGroup], list]":
        """(process group, its global ranks row-major over ``axes``) of
        the ranks that differ from this one only on ``axes``; the group
        is None (the default group) when it is the whole world."""
        return self._groups[self._key(axes)]

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def axis_index(self, axis: str) -> int:
        return self._coords[self._key(axis)[0]]

    def block_index(self, axes, rank: Optional[int] = None) -> int:
        """The index of this rank (or of global rank ``rank``) row-major
        over ``axes`` in the order given: the block of a dimension split
        over them (``P(axes)``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self._key(axes)
        coords = (self._coords if rank is None else
                  dict(zip(self.axes, _unravel(rank, self.shape.values()))))
        i = 0
        for a in axes:
            i = i * self.shape[a] + coords[a]
        return i


def _unravel(r: int, shape) -> list:
    out = []
    for s in reversed(list(shape)):
        out.append(r % s)
        r //= s
    return out[::-1]


def make_host_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the initialised world's ranks."""
    return Mesh(shape, axes)
