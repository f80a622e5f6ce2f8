"""Cluster membership and heartbeat-interval failure detection.

The control plane owns a :class:`MembershipTable`: every shard process
is a member with a lifecycle

    JOINING -> ALIVE <-> SUSPECT -> DEAD -> QUARANTINED

and an *incarnation* number that increments on every respawn (a reply
from a stale incarnation can never be confused with the replacement's).
Worker-slice ownership lives here too: normally rank r owns its own
contiguous slice of the worker axis, but degraded-mode ``rebind`` hands
a dead shard's slice to a survivor — ``owners()`` is the control plane's
single source of truth for who serves which rows of the ``(W, window)``
planes at checkpoint/gather time.

Failure detection is heartbeat-based in the synchronous-RPC sense: every
successful reply IS a heartbeat, and :class:`HeartbeatDetector` keeps a
sliding window of observed reply latencies, deriving the RPC deadline as
``median + k * MAD`` over the window (the same robust-threshold
machinery ``ft.runtime.StragglerMonitor`` applies to barrier walls,
via the shared ``mad_threshold`` helper — degenerate windows fall back
to the configured floor).  A shard that misses one adaptive deadline
turns SUSPECT; exhausting the backoff chain (or a dead pipe) makes it
DEAD, after which the control plane fences it with SIGKILL and
quarantines it — a partitioned-but-healthy process must never keep
mutating state it no longer owns.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.ft.runtime import mad_threshold


class ShardState(enum.Enum):
    JOINING = "joining"
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"
    QUARANTINED = "quarantined"


@dataclasses.dataclass
class MemberRecord:
    rank: int
    pid: int
    state: ShardState = ShardState.JOINING
    incarnation: int = 0
    home_slice: Tuple[int, int] = (0, 0)   # the slice this rank spawned with


class MembershipTable:
    """Who is in the cluster, what state they are in, who owns which
    worker slice."""

    def __init__(self):
        self.records: Dict[int, MemberRecord] = {}
        # rank -> list of owned (w_lo, w_hi) slices (rebind can stack
        # a dead peer's slice onto a survivor)
        self._owned: Dict[int, List[Tuple[int, int]]] = {}

    def add(self, rank: int, pid: int, w_lo: int, w_hi: int):
        self.records[rank] = MemberRecord(rank, pid,
                                          home_slice=(w_lo, w_hi))
        self._owned[rank] = [(w_lo, w_hi)]

    def mark(self, rank: int, state: ShardState):
        self.records[rank].state = state

    def state(self, rank: int) -> ShardState:
        return self.records[rank].state

    def reincarnate(self, rank: int, pid: int):
        """A replacement process took over this rank (respawn).  The
        home slice is reclaimed from any survivor a ``rebind`` handed
        it to — ownership must never double-count a row."""
        r = self.records[rank]
        r.pid = pid
        r.incarnation += 1
        r.state = ShardState.JOINING
        for other, slices in self._owned.items():
            if other != rank and r.home_slice in slices:
                slices.remove(r.home_slice)
        self._owned[rank] = [r.home_slice]

    def rebind(self, dead_rank: int, to_rank: int):
        """Degraded mode: hand every slice the dead rank owned to a
        survivor (who keeps serving at reduced capacity)."""
        assert to_rank != dead_rank
        moved = self._owned.pop(dead_rank, [])
        self._owned.setdefault(to_rank, []).extend(moved)

    def alive_ranks(self) -> List[int]:
        return sorted(r for r, rec in self.records.items()
                      if rec.state in (ShardState.ALIVE,
                                       ShardState.SUSPECT))

    def owners(self) -> List[Tuple[int, int, int]]:
        """Sorted ``(w_lo, w_hi, rank)`` ownership map over the whole
        worker axis — the checkpoint/gather fan-out plan."""
        out = [(lo, hi, rank) for rank, slices in self._owned.items()
               for lo, hi in slices
               if self.records[rank].state in (ShardState.ALIVE,
                                               ShardState.SUSPECT)]
        return sorted(out)


class HeartbeatDetector:
    """Adaptive RPC deadline from a sliding window of reply latencies:
    ``max(floor, median + k * MAD)``.  Fewer than 2 samples (or a cold
    start) fall back to the floor — the degenerate-window guard shared
    with StragglerMonitor."""

    def __init__(self, *, floor_s: float = 0.25, k: float = 6.0,
                 window: int = 64):
        assert floor_s > 0, floor_s
        self.floor_s = float(floor_s)
        self.k = float(k)
        self._lat: deque = deque(maxlen=int(window))

    def observe(self, latency_s: float):
        self._lat.append(float(latency_s))

    def timeout_s(self) -> float:
        return max(self.floor_s,
                   mad_threshold(self._lat, self.k, self.floor_s))

    def n_samples(self) -> int:
        return len(self._lat)
