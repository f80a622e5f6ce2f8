"""Fault-tolerance runtime: failure injection, straggler detection, elastic
rescale planning.

Failures are *injected* so the recovery paths run end to end:
``FailureInjector`` raises ``WorkerFailure`` at configured steps (the
engine's ``chaos_tick`` gives it its shot at every phase, span pass and
barrier), and ``ft.coherence.ChaosHarness`` restores the last barrier
checkpoint and replays the suffix.

Straggler detection is the scale-out analogue of the paper's observation
that one slow worker serializes every barrier: ``StragglerMonitor``
tracks per-step durations and flags outliers against a robust baseline
(median + k*MAD over a sliding window).  Host Python and numpy, as in
the reference package, whose behaviour this module repeats exactly.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np


class WorkerFailure(RuntimeError):
    """Simulated loss of a worker/host (network partition, preemption)."""

    def __init__(self, step: int, worker: int = 0, kind: str = "preemption"):
        super().__init__(f"worker {worker} failed at step {step} ({kind})")
        self.step, self.worker, self.kind = step, worker, kind


@dataclasses.dataclass
class FailureInjector:
    """Raise WorkerFailure at configured steps (each fires once).

    ``at_steps`` entries are either bare steps (``int``) — fire for
    whichever worker reaches the step first, any worker — or targeted
    ``(step, worker)`` pairs.  A bare step is stored as ``(step, None)``;
    callers that don't track workers (``check(step)``) still fire it
    exactly once, preserving the pre-targeting behavior.

    ``cluster_at`` carries *process-level* faults for the sharded runtime
    (``repro_torch.cluster``): ``(kind, step, rank)`` entries where kind is
    ``"kill"`` (SIGKILL the shard process), ``"partition_c2s"`` (drop the
    control->shard link direction) or ``"partition_s2c"`` (drop the
    shard->control direction).  These do not raise — the control plane
    polls :meth:`cluster_actions` at the top of each event round and
    *performs* the fault, then must detect and recover from it through
    its own membership machinery.  Each entry fires once."""

    at_steps: Sequence = ()
    kind: str = "preemption"
    cluster_at: Sequence = ()

    CLUSTER_KINDS = ("kill", "partition_c2s", "partition_s2c")

    def __post_init__(self):
        self._pending = set()
        for e in self.at_steps:
            if isinstance(e, tuple):
                s, w = e
                self._pending.add((int(s), None if w is None else int(w)))
            else:
                self._pending.add((int(e), None))
        self._cluster_pending = set()
        for kind, step, rank in self.cluster_at:
            if kind not in self.CLUSTER_KINDS:
                raise ValueError(f"unknown cluster fault kind {kind!r}; "
                                 f"allowed: {self.CLUSTER_KINDS}")
            self._cluster_pending.add((str(kind), int(step), int(rank)))

    def cluster_actions(self, step: int) -> List[Tuple[str, int]]:
        """Fire-once ``(kind, rank)`` process faults scheduled for
        ``step`` (sorted for determinism)."""
        hits = sorted(p for p in self._cluster_pending if p[1] == step)
        self._cluster_pending -= set(hits)
        return [(k, r) for k, _s, r in hits]

    def check(self, step: int, worker: Optional[int] = None):
        if not self._pending:
            return
        if worker is not None:
            hit = ((step, worker) if (step, worker) in self._pending
                   else (step, None) if (step, None) in self._pending
                   else None)
        else:
            # untargeted probe: a bare step fires for worker 0 (the old
            # behavior); a targeted entry at this step fires for its
            # worker (lowest id wins when several target the same step)
            cands = [p for p in self._pending if p[0] == step]
            if not cands:
                return
            bare = [p for p in cands if p[1] is None]
            hit = bare[0] if bare else min(
                cands, key=lambda p: p[1])
        if hit is None:
            return
        self._pending.discard(hit)
        w = hit[1]
        if w is None:
            w = worker if worker is not None else 0
        raise WorkerFailure(step, w, self.kind)


def mad_threshold(samples: Sequence[float], k: float,
                  floor: float) -> float:
    """Robust outlier threshold ``median + k * MAD`` over ``samples``,
    guarded against degenerate windows: with fewer than 2 samples there
    is no spread to estimate, so the fallback is ``floor`` (infinite
    when no floor is given) rather than a threshold derived from a
    meaningless MAD of 0.  Shared by :class:`StragglerMonitor` (barrier
    walls) and the cluster heartbeat detector (RPC latencies)."""
    xs = [float(x) for x in samples]
    if len(xs) < 2:
        return float(floor) if floor > 0 else math.inf
    med = StragglerMonitor._median(xs)
    mad = StragglerMonitor._median([abs(x - med) for x in xs]) or 1e-12
    return med + k * mad


class StragglerMonitor:
    """Sliding-window robust outlier detection on per-step durations.

    ``observe`` returns the list of flagged worker ids (empty when healthy).
    Detection: duration > median + k * MAD (and > abs_floor) over the last
    ``window`` steps, requiring ``patience`` consecutive flags before a
    worker is reported — a single GC pause is not a straggler.
    """

    def __init__(self, n_workers: int = 1, *, window: int = 32,
                 k: float = 4.0, abs_floor_s: float = 1e-4,
                 patience: int = 3):
        self.n = n_workers
        self.window = window
        self.k = k
        self.abs_floor = abs_floor_s
        self.patience = patience
        self._hist: List[deque] = [deque(maxlen=window)
                                   for _ in range(n_workers)]
        self._streak = [0] * n_workers
        self.flagged_total = 0

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        m = len(s) // 2
        return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])

    def observe(self, durations_s: Sequence[float]) -> List[int]:
        if len(durations_s) != self.n:
            raise ValueError(f"{len(durations_s)} durations for {self.n} "
                             "workers")
        for w, d in enumerate(durations_s):
            self._hist[w].append(float(d))
        pool = [d for h in self._hist for d in h]
        if len(pool) < max(8, self.n * 2):
            return []
        # mad_threshold carries the degenerate-window guard (<2 samples
        # -> no spread estimate); unreachable through the warm-up gate
        # above, but direct callers with window=1 configs hit it
        thresh = mad_threshold(pool, self.k, self.abs_floor)
        out = []
        for w, d in enumerate(durations_s):
            slow = d > thresh and d > self.abs_floor
            self._streak[w] = self._streak[w] + 1 if slow else 0
            if self._streak[w] >= self.patience:
                out.append(w)
        self.flagged_total += len(out)
        return out

    # -- snapshot support (ft/coherence.py) -----------------------------
    def config(self) -> dict:
        return {"n_workers": self.n, "window": self.window, "k": self.k,
                "abs_floor_s": self.abs_floor, "patience": self.patience}

    def state_arrays(self) -> dict:
        """Mutable detection state (windows, streaks, totals) as numpy
        arrays — the checkpoint payload alongside :meth:`config`."""
        counts = np.array([len(h) for h in self._hist], np.int64)
        flat = np.array([d for h in self._hist for d in h], np.float64)
        return {"hist": flat, "hist_counts": counts,
                "streak": np.asarray(self._streak, np.int64),
                "flagged_total": np.array([self.flagged_total], np.int64)}

    @classmethod
    def from_state(cls, arrays: dict, config: dict) -> "StragglerMonitor":
        m = cls(int(config["n_workers"]), window=int(config["window"]),
                k=float(config["k"]),
                abs_floor_s=float(config["abs_floor_s"]),
                patience=int(config["patience"]))
        counts = np.asarray(arrays["hist_counts"], np.int64)
        flat = np.asarray(arrays["hist"], np.float64)
        off = 0
        for w in range(m.n):
            n = int(counts[w])
            m._hist[w].extend(float(x) for x in flat[off:off + n])
            off += n
        m._streak = [int(x) for x in np.asarray(arrays["streak"],
                                                np.int64)]
        m.flagged_total = int(np.asarray(arrays["flagged_total"])[0])
        return m


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A rescale decision: new data-parallel world and per-rank batch.

    The global batch is preserved exactly when divisible; otherwise it is
    rounded DOWN to a multiple of the new world (recorded in
    ``dropped_samples`` — optimizer scale stays correct because gradients
    are averaged, not summed)."""

    old_world: int
    new_world: int
    global_batch: int

    @property
    def new_global_batch(self) -> int:
        return (self.global_batch // self.new_world) * self.new_world

    @property
    def dropped_samples(self) -> int:
        return self.global_batch - self.new_global_batch

    @property
    def local_batch(self) -> int:
        return self.new_global_batch // self.new_world

    def describe(self) -> str:
        return (f"rescale {self.old_world}->{self.new_world} workers, "
                f"global_batch {self.global_batch}->{self.new_global_batch} "
                f"(local {self.local_batch})")


def plan_rescale(old_world: int, failed: Sequence[int], global_batch: int,
                 *, spares: int = 0) -> ElasticPlan:
    """Shrink (or refill from spares) after failures."""
    new_world = old_world - len(set(failed)) + spares
    if new_world < 1:
        raise ValueError("no workers left")
    return ElasticPlan(old_world, new_world, global_batch)
