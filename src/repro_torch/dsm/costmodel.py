"""Linear (alpha-beta) interconnect + node cost model.

Traffic counts in the DSM runtime are EXACT (every byte is accounted as
the protocol moves it); only *time* is modeled, as latency +
bytes/bandwidth.  ``IB_2013`` is the paper's System G: QDR InfiniBand
(32 Gbit/s effective, ~1.3 us), dual quad-core 2.8 GHz Harpertown nodes
(8 cores/node), node memory bandwidth ~6.4 GB/s shared across the node's
cores.  The constants and every formula are those of the reference
package, so modeled clocks agree bit for bit.

``ChaosNet`` layers deterministic message loss on the model: host numpy
uint64 hashes of (seed, worker, sequence), the reference's drop
decisions and retry charges bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    name: str
    net_latency_s: float          # per message
    net_bw_Bps: float             # per link
    node_mem_bw_Bps: float        # all sockets of a node combined
    node_size: int                # workers per node (placement fills nodes)
    flops_per_worker: float       # SUSTAINED scalar flops per worker
    socket_size: int = 0          # 0 = no socket effect; else cores/socket:
    #   <= socket_size workers see only one socket's memory bandwidth
    #   (node_mem_bw / n_sockets), the paper's fill-socket-0-first placement

    def node_bw(self, workers_sharing: int) -> float:
        if self.socket_size and workers_sharing <= self.socket_size:
            n_sockets = max(1, self.node_size // self.socket_size)
            return self.node_mem_bw_Bps / n_sockets
        return self.node_mem_bw_Bps

    def xfer_s(self, n_bytes: float, n_msgs: int = 1) -> float:
        return self.net_latency_s * n_msgs + n_bytes / self.net_bw_Bps

    def mem_s(self, n_bytes: float, workers_sharing: int = 1) -> float:
        bw = self.node_bw(workers_sharing) / max(1, workers_sharing)
        return n_bytes / bw

    def compute_s(self, flops: float = 0.0, mem_bytes: float = 0.0,
                  workers_sharing: int = 1) -> float:
        return max(flops / self.flops_per_worker,
                   self.mem_s(mem_bytes, workers_sharing))

    def workers_on_node(self, n_workers: int) -> int:
        return min(n_workers, self.node_size)


IB_2013 = CostModel(
    name="ib2013",
    net_latency_s=1.3e-6,
    net_bw_Bps=4.0e9,             # QDR 32 Gbit/s
    node_mem_bw_Bps=6.4e9,        # Penryn Harpertown node (STREAM-class)
    node_size=8,
    socket_size=4,                # dual quad-core, fill-first placement
    flops_per_worker=2.8e9,       # 2.8 GHz, ~1 sustained flop/cycle
)


# ---------------------------------------------------------------------------
# message loss (chaos tier)
# ---------------------------------------------------------------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (array ops only — numpy
    scalar uint64 arithmetic warns on the intended wraparound)."""
    x = (x + _SM_GAMMA)
    x ^= x >> np.uint64(30)
    x *= _SM_M1
    x ^= x >> np.uint64(27)
    x *= _SM_M2
    x ^= x >> np.uint64(31)
    return x


class ChaosNet:
    """Deterministic message-loss model layered on a :class:`CostModel`.

    Every clock-charged message-group event on the protocol path consumes
    exactly one per-worker sequence tick; the (seed, worker, seq) triple
    hashes to a drop decision per retry level, so losses are a pure
    function of each worker's own event history — independent of how a
    driver batches workers together.  That is what keeps the loop and
    batched drivers bit-equal under chaos: both produce the same
    per-worker sequence of charge events (the engine's exactness
    invariant), hence the same ticks, hence the same retry charges.

    A dropped message is retransmitted after ``timeout_s`` with
    exponential backoff: r consecutive drops charge
    ``sum_{k<r} timeout_s * backoff**min(k, backoff_cap)`` extra seconds
    (capped at ``max_retries`` levels — the last retransmission always
    succeeds, so the protocol outcome and traffic counters never change,
    only time).  ``backoff_cap`` bounds the per-level exponent so deep
    retry chains (large ``max_retries``) charge linearly past the cap
    instead of geometrically without bound; the default cap (6) is above
    the default chain depth, so stock configurations are unchanged.

    Invalidation messages charge no clock in the base model, so their
    losses are accounted on a separate GLOBAL sequence counter as
    stats-only retransmissions (``inval_retries``): the total over N
    consumed indices is partition-independent, preserving driver
    equality from the cumulative invalidation-count equality.
    """

    def __init__(self, *, seed: int = 0, drop_rate: float = 0.05,
                 timeout_s: float = 5e-6, backoff: float = 2.0,
                 max_retries: int = 3, backoff_cap: int = 6):
        if not (0.0 <= drop_rate < 1.0 and max_retries >= 1
                and backoff_cap >= 0):
            raise ValueError(f"ChaosNet needs 0 <= drop_rate < 1, "
                             f"max_retries >= 1 and backoff_cap >= 0; got "
                             f"{drop_rate}, {max_retries}, {backoff_cap}")
        self.seed = int(seed)
        self.drop_rate = float(drop_rate)
        self.timeout_s = float(timeout_s)
        self.backoff = float(backoff)
        self.max_retries = int(max_retries)
        self.backoff_cap = int(backoff_cap)
        self.W = 0
        self.msg_seq = np.zeros(0, np.uint64)       # per-worker event count
        self.inval_seq = np.zeros(1, np.uint64)     # global inval msg count
        self._stats: dict = {}
        self._seed_u = np.uint64(np.int64(self.seed))

    # -- wiring ---------------------------------------------------------
    def bind(self, n_workers: int, stats: dict):
        """Attach to a runtime: allocate per-worker counters and route the
        chaos_* counters into the runtime's ``stats`` dict."""
        if self.W != n_workers:
            self.W = n_workers
            self.msg_seq = np.zeros(n_workers, np.uint64)
            self.inval_seq = np.zeros(1, np.uint64)
        self._stats = stats
        for k in ("chaos_msgs", "chaos_drops", "chaos_inval_retries"):
            stats.setdefault(k, 0)

    def config(self) -> dict:
        return {"seed": self.seed, "drop_rate": self.drop_rate,
                "timeout_s": self.timeout_s, "backoff": self.backoff,
                "max_retries": self.max_retries,
                "backoff_cap": self.backoff_cap}

    def state_arrays(self) -> dict:
        return {"chaos_msg_seq": self.msg_seq.copy(),
                "chaos_inval_seq": self.inval_seq.copy()}

    def load_state(self, arrays: dict):
        self.msg_seq = np.asarray(arrays["chaos_msg_seq"],
                                  np.uint64).copy()
        self.inval_seq = np.asarray(arrays["chaos_inval_seq"],
                                    np.uint64).copy()
        self.W = self.msg_seq.size

    # -- drop decisions -------------------------------------------------
    def _dropped(self, lane: np.ndarray, seq: np.ndarray,
                 level: int) -> np.ndarray:
        h = _splitmix64(_splitmix64(_splitmix64(
            lane + self._seed_u) ^ seq) + np.uint64(level))
        u = (h >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
        return u < self.drop_rate

    def _consecutive_drops(self, lane: np.ndarray,
                           seq: np.ndarray) -> np.ndarray:
        """Number of consecutive drops (0..max_retries) per element."""
        r = np.zeros(lane.shape, np.int64)
        alive = np.ones(lane.shape, bool)
        for k in range(self.max_retries):
            d = alive & self._dropped(lane, seq, k)
            if not d.any():
                break
            r[d] += 1
            alive = d
        return r

    # -- charged-path API -----------------------------------------------
    def retry_rows(self, rows: np.ndarray) -> np.ndarray:
        """Consume one message tick per worker in ``rows`` (distinct
        worker ids) and return the extra retransmission seconds each owes.
        Charged-path only: the caller adds the result to the clock as a
        SEPARATE ``+=`` right after the base charge, so loop and batched
        drivers execute identical float-op sequences."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return np.zeros(0, np.float64)
        lane = rows.astype(np.uint64)
        seq = self.msg_seq[rows]
        r = self._consecutive_drops(lane, seq)
        self.msg_seq[rows] += np.uint64(1)
        st = self._stats
        st["chaos_msgs"] = st.get("chaos_msgs", 0) + int(rows.size)
        ndrop = int(r.sum())
        if ndrop:
            st["chaos_drops"] = st.get("chaos_drops", 0) + ndrop
        # sum_{k<r} timeout * backoff^min(k, cap), elementwise
        # (r <= max_retries; the cap keeps deep chains linear past it)
        extra = np.zeros(rows.size, np.float64)
        for k in range(self.max_retries):
            m = r > k
            if not m.any():
                break
            extra[m] += self.timeout_s * (
                self.backoff ** min(k, self.backoff_cap))
        return extra

    @staticmethod
    def backoff_seconds(timeout_s: float, backoff: float, levels: int,
                        cap: int = 6) -> float:
        """The retry charge for ``levels`` consecutive timeouts — the same
        capped-exponent term :meth:`retry_rows` charges per element.  The
        cluster control plane uses this to account real RPC retries in
        its availability report without touching the modeled clocks."""
        return float(sum(timeout_s * backoff ** min(k, cap)
                         for k in range(levels)))

    def retry1(self, w: int) -> float:
        """Scalar path: delegates to :meth:`retry_rows` on a 1-element
        array so the charge is bit-identical to the vector path."""
        return float(self.retry_rows(np.array([w], np.int64))[0])

    # -- invalidation (uncharged) path ----------------------------------
    def inval_msgs(self, n: int):
        """Consume ``n`` global invalidation-message indices and account
        their retransmissions (stats only — the base model charges no
        clock for invalidations, so neither does their loss)."""
        if n <= 0:
            return
        start = self.inval_seq[0:1]
        idx = start + np.arange(n, dtype=np.uint64)
        lane = np.full(n, 0xA5A5A5A5A5A5A5A5, np.uint64)
        r = self._consecutive_drops(lane, idx)
        self.inval_seq += np.uint64(n)
        nr = int(r.sum())
        if nr:
            st = self._stats
            st["chaos_inval_retries"] = (
                st.get("chaos_inval_retries", 0) + nr)
