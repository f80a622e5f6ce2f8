"""Meshes over the ranks of a ``torch.distributed`` process group (the
port of the reference's ``launch/mesh.py``: ``make_host_mesh``,
``make_production_mesh`` and the roofline constants, an H100's).

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

``AbstractMesh`` is the same layout with no process group: one rank's
view of a mesh that need not exist (the launch analysis's production
meshes, ``make_production_mesh``).  The collectives of
``models.collectives`` count a message on it as on a real rank and send
nothing.  The H100 constants below are the roofline's denominators
(``launch.dryrun``).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


# NVIDIA H100 80GB HBM3, 700 W (SXM): the roofline's denominators, a card.
# bf16 dense tensor-core peak
PEAK_FLOPS_BF16 = 989e12
# float32 on the CUDA cores (TF32 off, as every float comparison runs)
PEAK_FLOPS_F32 = 67e12
# HBM3 bytes/s
HBM_BW = 3.35e12
# the collective term's bytes/s: one NDR 400 Gb/s InfiniBand port per card,
# one direction.  A 16-wide axis of a 16x16 or 2x16x16 mesh of eight-card
# nodes always crosses nodes.  An axis within a node would run on NVLink
# at NVLINK_BW a direction.
NET_BW = 50e9
NVLINK_BW = 450e9
# torch.cuda.get_device_properties(0).total_memory, as torch 2.11 (CUDA
# 12.8) reads it on the card (79.18 GiB)
HBM_PER_CHIP = 85_017_493_504


def _check_layout(shape, axes):
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ")
    return shape, axes


class MeshLayout:
    """Named axes row-major over the ranks, seen from global rank
    ``rank``: what ``Mesh`` and ``AbstractMesh`` share."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        shape, axes = _check_layout(shape, axes)
        if not 0 <= rank < math.prod(shape):
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{math.prod(shape)}")
        self.axes = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.rank = int(rank)
        self._coords = dict(zip(axes, _unravel(self.rank, shape)))

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


class AbstractMesh(MeshLayout):
    """The layout of a mesh of ``shape`` over ``axes`` seen from global
    rank ``rank``, with ``Mesh``'s interface and no process group: no
    rank but this one exists, and the collectives count their messages
    and send none."""

    def group(self, axes) -> "tuple[None, list]":
        """(None, the global ranks that differ from this one only on
        ``axes``, row-major over them)."""
        sub = self._key(axes)
        return None, [self._rank_at({**self._coords, **dict(zip(sub, c))})
                      for c in itertools.product(
                          *(range(self.shape[a]) for a in sub))]


class Mesh(MeshLayout):
    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = _check_layout(shape, axes)
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialised process group "
                               "(repro_torch.launch.ranks.init_world)")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} holds "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{world}")
        super().__init__(shape, axes, dist.get_rank())
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

    def group(self, axes) -> "tuple[Optional[dist.ProcessGroup], list]":
        """(process group, its global ranks row-major over ``axes``) of
        the ranks that differ from this one only on ``axes``; the group
        is None (the default group) when it is the whole world."""
        return self._groups[self._key(axes)]


def _unravel(r: int, shape) -> list:
    out = []
    for s in reversed(list(shape)):
        out.append(r % s)
        r //= s
    return out[::-1]


def make_host_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the initialised world's ranks."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> AbstractMesh:
    """The reference's production mesh as rank ``rank`` sees it: (16, 16)
    over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with ``multi_pod`` (the pod axis the inter-pod one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes, rank)
