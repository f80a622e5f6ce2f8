"""Directory-vectorized RegC protocol engine for paper-scale runs, on a
torch device.

The same protocol and the same traffic accounting as the reference
package's ``RegCScaleRuntime``: every cross-worker path is vectorized over
the worker axis through one ``RegionDirectory`` per allocation region,
whose valid/dirty/wprot planes are torch bool tensors on the runtime's
device.  The barrier flush reduces the dirty planes on the device — one
``phase_step`` kernel launch per flush on the 'fused' tier, per-op
``popcount_rows``/``coverage_multi`` kernels on 'kernels', torch bool
reductions on the CPU-only 'plain' tier — and the host reads back only
counts and the sparse shared-dirty candidates.

Exactness: traffic is integer-exact, and every clock charge runs on the
host in float64 in the reference's order of operations, so clocks are
bit-equal to the reference on the same program (the parity tests check
this after every event).

Under ``cache_pages`` each worker holds at most that many pages
(watermark eviction, exact LRU through a tick-ordered queue of touch
runs, as in the reference).  ``phase_all`` stays batched under spill: a
window-disjointness analysis proves which workers' evictions cannot
interact, those evict with segment-LRU plane ops (``take_first_k``
masks from the bool runs, ``popcount_rows`` dirty-victim counts from
the bool planes), and the rest replay per worker in tick order.  Ops that can
evict a page of their own range before touching it resolve through the
analytic evict-then-refetch schedule (``_danger_replay``), whose victim
scan is one rank-select launch read back in one copy (``take_run``);
``danger_mode="scalar"`` forces the per-page walk
the reference uses as its oracle.  The LRU queues, the resident counts and
the ticks are host state, like the window geometry; the touch/incache
planes live on the device.

Consistency regions run batched through ``span_all``: the masked
workers' acquire-time flushes hoist into one masked barrier-style flush
(``phase_step`` with its row mask on 'fused'), and each uniform grant
group resolves as (G, P) plane ops on the device around a host clock
chain that repeats the per-worker charges term for term.

Race detection (``detect_races=True``) is a pure observer, as in the
reference: per-worker vector clocks on the host, the directories' race
planes on the device, and one end-of-call pass over the declared ranges
of each ``phase_all``/``span_all`` call (the scalar hooks are suspended
inside them), which checks every worker of an op in one batched gather.

Fault tolerance, as in the reference: ``chaos`` (a
``dsm.costmodel.ChaosNet``) adds a retry charge after every clock-charged
message group and counts lost invalidations, on the same vectorized paths;
``chaos_tick`` gives an ``injector`` its shot at the entry of
``phase_all``, ``span_all`` and ``barrier``; a ``straggler`` monitor
observes each barrier's per-worker walls; and ``snapshot`` /
``from_snapshot`` carry the complete state at a barrier cut in the
reference's format (its array names, dtypes and meta keys), so a run can
move between the two packages in either direction.

This engine covers slices A (the main path), B (eviction), D
(consistency-region spans), E (race detection) and F (the serving
workload and crash recovery) of the port; slice C is the per-page
reference engine (``core/regc.py``).

Store-tracking mechanisms (paper §IV), modeled as in the reference:

* ``fine``  (samhita): every store is instrumented with a runtime call ->
  ``instr_s_per_word`` per stored word, ordinary AND consistency regions;
* ``page``  (samhita_page): write detection via VM protection -> one
  ``fault_s`` per (page x write-epoch), re-armed when the page is flushed.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import (BACKENDS, DANGER_MODES, FAULT_S,
                                     FINE_PROTO, IDEAL_PROTO,
                                     INSTR_S_PER_WORD, PAGE_PROTO, PROTOCOLS,
                                     check_choice, resolve_device)
from repro_torch.core.directory import (IntervalLog, RegionDirectory, host,
                                        use_dense)
from repro_torch.core.regc import _WORD, GasArray, Traffic
from repro_torch.dsm.costmodel import IB_2013, CostModel
from repro_torch.kernels import protocol_sweep as _ps

# the reference's names of this package's tiers (its snapshot vocabulary)
_REF_BACKEND = {"plain": "numpy", "kernels": "pallas", "fused": "pallas-jit"}
_OUR_BACKEND = {v: k for k, v in _REF_BACKEND.items()}

# the reference's stats keys (its jit_* accounting aside), so stats of the
# two engines compare key for key; race_ww / race_rw count each new
# flagged race once
_STATS_KEYS = ("batched_phases", "evict_batch_rounds", "danger_ops",
               "residual_replays", "danger_vec_ops", "danger_scalar_ops",
               "danger_shared_ops", "danger_subgroup_ops", "span_all_calls",
               "span_serial_calls", "span_groups_vec", "span_workers_vec",
               "span_multi_region_groups", "span_serial_workers",
               "span_backlog_serial", "race_ww", "race_rw")


def _window_pairs(d: RegionDirectory, rows: np.ndarray, pages: np.ndarray):
    """Every (row, page) pair of the sorted host page list ``pages`` that
    lies in a row's window, row-major: host (row, index into ``pages``,
    column in the row).  Work tracks actual window coverage, not
    rows x pages."""
    b = d.base[rows]
    i0 = np.searchsorted(pages, b)
    n = np.maximum(np.searchsorted(pages, b + d.length[rows]) - i0, 0)
    pr = np.repeat(rows, n)
    pi = np.arange(int(n.sum())) + np.repeat(i0 - (np.cumsum(n) - n), n)
    return pr, pi, pages[pi] - d.base[pr]


class _Span:
    __slots__ = ("lock", "touched", "plane", "bounds")

    def __init__(self, lock, plane: bool = False):
        self.lock = lock
        self.plane = plane
        # a depth-1 span tracks its touches in the directory's span
        # planes, with ``bounds`` the touched page interval per region;
        # nested (inner) spans keep a per-page dict
        self.touched: Optional[Dict[int, Tuple[int, int]]] = (
            None if plane else {})
        self.bounds: Optional[Dict[int, list]] = {} if plane else None


class _Lock:
    __slots__ = ("version", "log", "last_release_time", "seen", "race_vc")

    def __init__(self, n_workers):
        self.version = 0
        self.log = IntervalLog()
        self.last_release_time = 0.0
        self.seen = np.zeros(n_workers, np.int64)
        # detect_races only: the join of every releaser's vector clock
        self.race_vc = np.zeros(n_workers, np.int64)


class RegCScaleRuntime:
    """Metadata-only, directory-vectorized RegC engine on a torch device."""

    def __init__(self, n_workers: int, *, page_words: int = 1024,
                 protocol: str = FINE_PROTO, cost: CostModel = IB_2013,
                 prefetch: int = 1,
                 model_mechanism: bool = True,
                 instr_s_per_word: float = INSTR_S_PER_WORD,
                 fault_s: float = FAULT_S, fetch_batch: int = 1,
                 backend: str = "fused", cache_pages: Optional[int] = None,
                 danger_mode: str = "vec", detect_races: bool = False,
                 chaos=None, injector=None, straggler=None, device=None):
        check_choice("protocol", protocol, PROTOCOLS)
        check_choice("backend", backend, BACKENDS)
        # 'vec' resolves danger-flagged ops through the analytic refetch
        # schedule, 'scalar' through the per-page walk (the oracle)
        check_choice("danger_mode", danger_mode, DANGER_MODES)
        self.danger_mode = danger_mode
        self.cache_pages = cache_pages
        self.device = resolve_device(device, backend)
        self.backend = backend
        self.W = n_workers
        self.page_words = page_words
        self.page_bytes = page_words * _WORD
        self.protocol = protocol
        self.cost = cost
        self.prefetch = prefetch
        self.model_mechanism = model_mechanism
        self.instr_s_per_word = instr_s_per_word
        self.fault_s = fault_s
        # Samhita's bulk-fetch optimization (paper §V-A): a miss run of k
        # pages costs ceil(k/fetch_batch) request/reply pairs, not k
        self.fetch_batch = max(1, fetch_batch)
        self._track_wprot = (protocol == PAGE_PROTO and model_mechanism)
        self._track_touch = cache_pages is not None

        self.n_pages = 0
        self._region_starts: List[int] = []     # sorted page_lo per region
        self._region_ends: List[int] = []
        self._region_starts_np = np.zeros(0, np.int64)
        self.dirs: List[RegionDirectory] = []
        self.spans: List[List[_Span]] = [[] for _ in range(n_workers)]
        self.locks: Dict[int, _Lock] = {}
        self.clock = np.zeros(n_workers)
        self.traffic = Traffic()
        # per-worker cache occupancy (valid + invalidated-but-not-evicted
        # pages): the eviction watermark
        self.resident = np.zeros(n_workers, np.int64)
        # per-worker FIFO of touch runs
        # [t0, region, col0, n, off, shift0, pristine]: one monotone tick
        # per run, so the queue is tick-ordered and an LRU pop is a front
        # scan that lazily skips re-touched and evicted cells; pristine
        # runs were never overlapped by a later op of the same worker, so
        # their live cells are exactly the [off, n) suffix
        self._lru_q: List[deque] = [deque() for _ in range(n_workers)]
        self._q_degraded = np.zeros(n_workers, bool)
        # when a dict, _danger_replay records its eviction schedule into
        # it (the shared-schedule leader run, see _danger_shared)
        self._danger_rec: Optional[dict] = None
        self._dirty_regions: List[set] = [set() for _ in range(n_workers)]
        self._reductions: Dict[str, List[Tuple[float, str]]] = {}
        self._reduction_results: Dict[str, float] = {}
        self._tick = 0
        self._rows_all = np.arange(n_workers)
        # path counters: the reference's keys, plus 'fused_dispatches' —
        # device calls made by the fused tier (one phase_step per flush;
        # the counterpart of the reference's pallas-jit jit_dispatches)
        self.stats = dict.fromkeys(_STATS_KEYS, 0)
        self.stats["fused_dispatches"] = 0
        # fault tolerance, as in the reference (see ft/coherence.py):
        # ``chaos`` a dsm.costmodel.ChaosNet (one per-worker tick per
        # clock-charged message group, its retry charge added as a
        # separate ``+=`` right after the base charge, so both drivers
        # and every tier stay bit-equal); ``injector`` a
        # ft.runtime.FailureInjector fired by ``chaos_tick``; ``straggler``
        # a ft.runtime.StragglerMonitor observed at every barrier
        self.chaos = chaos
        self.injector = injector
        self.straggler = straggler
        if chaos is not None:
            chaos.bind(n_workers, self.stats)
        if straggler is not None:
            if straggler.n != n_workers:
                raise ValueError(f"straggler monitor for {straggler.n} "
                                 f"workers on a {n_workers}-worker runtime")
            self.stats.setdefault("straggler_checks", 0)
            self.stats.setdefault("straggler_flags", 0)
        self._phase_idx = 0
        self._bar_clock0 = np.zeros(n_workers)
        # race detection (a pure observer): per-worker vector clocks
        # (epochs start at 1), the canonical flagged set of
        # (page, a, b, kind) with a < b, and the flag that suspends the
        # scalar hooks inside phase_all / span_all, whose end-of-call pass
        # covers every path of the call once
        self.detect_races = detect_races
        self.race_vc = (np.eye(n_workers, dtype=np.int64)
                        if detect_races else None)
        self.races: set = set()
        self._race_suspend = False

    def chaos_tick(self):
        """Advance the phase-program position and give the failure
        injector its shot.  Called at the entry of ``phase_all``,
        ``span_all`` and ``barrier``, before any state changes (so a
        raise leaves the runtime exactly as the previous event left it);
        loop-driver harnesses call it once per equivalent event."""
        self._phase_idx += 1
        if self.injector is not None:
            self.injector.check(self._phase_idx)

    # ------------------------------------------------------------------
    def alloc(self, n_elems: int) -> GasArray:
        pages = -(-n_elems // self.page_words)
        ga = GasArray(self.n_pages, n_elems, self.page_words)
        self._region_starts.append(self.n_pages)
        self._region_ends.append(self.n_pages + pages)
        self._region_starts_np = np.asarray(self._region_starts, np.int64)
        d = RegionDirectory(
            self.W, len(self.dirs), self.n_pages, self.n_pages + pages,
            track_wprot=self._track_wprot, track_touch=self._track_touch,
            backend=self.backend, device=self.device)
        d.stats = self.stats
        self.dirs.append(d)
        self.n_pages += pages
        return ga

    def _region_of(self, page: int) -> int:
        i = bisect.bisect_right(self._region_starts, page) - 1
        if i < 0 or page >= self._region_ends[i]:
            raise ValueError(f"page {page} lies in no allocated region")
        return i

    def _net(self, w: int, n_bytes: float, msgs: int = 1):
        if self.protocol == IDEAL_PROTO:
            return
        self.clock[w] += self.cost.xfer_s(n_bytes, msgs)
        if self.chaos is not None:
            self.clock[w] += self.chaos.retry1(w)

    def compute(self, w: int, *, flops: float = 0.0, mem_bytes: float = 0.0,
                seconds: float = 0.0):
        self.clock[w] += seconds + self.cost.compute_s(
            flops, mem_bytes, self.cost.workers_on_node(self.W))

    def instr_stores(self, w: int, n_words: float):
        """Inner-loop stores to shared memory that the LLVM pass instruments
        (e.g. MD force accumulation): charged per word under the fine
        protocol; under the page protocol they hit already-faulted pages."""
        if self.model_mechanism and self.protocol == FINE_PROTO:
            self.clock[w] += n_words * self.instr_s_per_word

    # ------------------------------------------------------------------
    # interval fetch / LRU eviction (cache_pages)
    # ------------------------------------------------------------------

    _Q_SCAN_LIMIT = 64

    def _q_append(self, w: int, region: int, col0: int, n: int,
                  shift0: int) -> int:
        """Append a touch run to w's tick-ordered LRU queue and return its
        fresh (monotone) tick.  Older queued runs of the same region whose
        live span overlaps the new run lose their ``pristine`` flag; queues
        longer than the scan limit degrade wholesale to non-pristine,
        keeping appends O(1) amortized."""
        self._tick += 1
        q = self._lru_q[w]
        pristine = True
        if len(q) > self._Q_SCAN_LIMIT:
            if not self._q_degraded[w]:
                for e in q:
                    e[6] = False
                self._q_degraded[w] = True
            pristine = False
        else:
            self._q_degraded[w] = False
            hi = col0 + n
            for e in q:
                if e[1] != region or not e[6]:
                    continue
                ec0 = e[2] + (shift0 - e[5])
                if ec0 + e[4] < hi and ec0 + e[3] > col0:
                    e[6] = False
        q.append([self._tick, region, col0, n, 0, shift0, pristine])
        return self._tick

    def _fetch_range(self, w: int, region: int, p_lo: int, p_hi: int):
        """Make pages [p_lo, p_hi) valid at w, charging misses."""
        d = self.dirs[region]
        d.ensure(w, p_lo, p_hi)
        s = d.sl(w, p_lo, p_hi)
        n = p_hi - p_lo
        n_miss = n - int(d.valid[w, s].sum())
        if d.touch is not None:
            # one monotone tick per touch run: column order within a run
            # is the per-op LRU order
            d.touch[w, s] = self._q_append(w, region, s.start, n,
                                           int(d.shift[w]))
            n_enter = n - int(d.incache[w, s].sum())
            if n_enter:
                d.incache[w, s] = True
                self.resident[w] += n_enter
        if n_miss:
            if self.protocol != IDEAL_PROTO:
                self.traffic.page_fetches += n_miss
                self.traffic.fetch_bytes += n_miss * self.page_bytes
                n_req = -(-n_miss // self.fetch_batch)
                self._net(w, n_miss * self.page_bytes, 2 * n_req)
            d.valid[w, s] = True

    def _danger(self, w: int, n_enter: int, n: int) -> bool:
        """Batched end-of-op eviction is exact unless this op can evict a
        page of its own range (one already occupying a cache slot) before
        touching it, which the reference would refetch mid-op: that needs
        an in-cache page in the range and an eviction this op."""
        return (self.cache_pages is not None
                and self.protocol != IDEAL_PROTO
                and n_enter < n
                and int(self.resident[w]) + n_enter > self.cache_pages)

    def _evict_now(self, w: int, d: RegionDirectory, vc: np.ndarray):
        """Evict the host columns ``vc`` (ascending tick order) of w's row
        in region d: dirty victims write back first (one message per page,
        as the reference's per-page eviction flush), then valid and the
        cache slot drop."""
        lo, hi = int(vc[0]), int(vc[-1]) + 1
        sl = slice(lo, hi) if hi - lo == vc.size else d.ix(vc)
        dmask = host(d.dirty[w, sl])
        if dmask.any():
            db = vc[dmask]
            d.dirty[w, sl] = False     # only the db cells were set
            if self.protocol != IDEAL_PROTO:
                self.traffic.writeback_bytes += db.size * self.page_bytes
                self.clock[w] += (self.cost.net_latency_s * db.size
                                  + db.size * self.page_bytes
                                  / self.cost.net_bw_Bps)
                if self.chaos is not None:
                    self.clock[w] += self.chaos.retry1(w)
                if d.wprot is not None:
                    d.wprot[w, d.ix(db)] = True
                self._invalidate_sharers(w, d.region, d.base[w] + db)
        d.valid[w, sl] = False
        d.incache[w, sl] = False
        self.resident[w] -= vc.size

    def _evict_cells(self, w: int, k: int):
        """Evict w's k least-recently-touched cache occupants, scanning the
        tick-ordered run queue from the front and lazily skipping cells
        that were re-touched or already evicted."""
        q = self._lru_q[w]
        while k > 0:
            run = q[0]
            t0, region, col0, n, off, shift0, pristine = run
            d = self.dirs[region]
            c0 = col0 + (int(d.shift[w]) - shift0)
            if pristine:
                # never re-touched: the victims are a contiguous prefix
                tk = min(k, n - off)
                self._evict_now(w, d, np.arange(c0 + off, c0 + off + tk))
                k -= tk
                if off + tk == n:
                    q.popleft()
                else:
                    run[4] = off + tk
                continue
            sl = slice(c0 + off, c0 + n)      # run cells are contiguous
            idx = np.nonzero(host((d.touch[w, sl] == t0)
                                  & d.incache[w, sl]))[0]
            if idx.size == 0:
                q.popleft()
                continue
            take = idx[:k]
            self._evict_now(w, d, c0 + off + take)
            k -= take.size
            if take.size == idx.size:
                q.popleft()          # no live cells remain in this run
            else:
                run[4] = off + int(take[-1]) + 1

    def _touch_page_exact(self, w: int, d: RegionDirectory, p: int,
                          fetch: bool) -> int:
        """Per-page touch/fetch + immediate LRU eviction, the reference's
        page-by-page sequence for dangerous ops.  Returns the pages fetched
        (0/1); the caller charges the op's fetch messages once."""
        col = p - int(d.base[w])
        valid, inc = torch.stack([d.valid[w, col], d.incache[w, col]]).tolist()
        n_miss = 0
        if not valid:
            if fetch and self.protocol != IDEAL_PROTO:
                self.traffic.page_fetches += 1
                self.traffic.fetch_bytes += self.page_bytes
                n_miss = 1
            d.valid[w, col] = True
        if not inc:
            d.incache[w, col] = True
            self.resident[w] += 1
        d.touch[w, col] = self._q_append(w, d.region, col, 1,
                                         int(d.shift[w]))
        if self.resident[w] > self.cache_pages:
            self._evict_cells(w, int(self.resident[w]) - self.cache_pages)
        return n_miss

    def _danger_replay(self, w: int, d: RegionDirectory, region: int,
                       p_lo: int, p_hi: int,
                       fetch_flag: Optional[np.ndarray], *,
                       is_write: bool) -> int:
        """The reference's analytic evict-then-refetch schedule for one
        danger-flagged op: within the op the touch front sweeps the op's
        columns while the eviction front consumes the worker's LRU victim
        stream in tick order, and the two meet only at the op's in-cache
        segments (maximal column runs owned by one pre-op touch run).  A
        segment none of whose cells was evicted goes stale at no cost; one
        whose prefix was evicted evicts-then-refetches whole.  Victims are
        consumed run by run; a run that outlives the demand goes through
        ``take_upto_row``'s rank-select kernel on the device.  Once the
        pre-op stream is dry the op consumes its own oldest columns (a
        prefix).  ``fetch_flag`` marks the pages that charge a fetch when
        invalid at touch time (None = all).  Returns the fetch-miss count;
        the caller charges the op's fetch messages once."""
        C = int(self.cache_pages)
        base = int(d.base[w])
        c0 = int(p_lo) - base
        n = int(p_hi) - int(p_lo)
        s = slice(c0, c0 + n)
        incache0, valid0, dirty0 = torch.stack(
            [d.incache[w, s], d.valid[w, s], d.dirty[w, s]]).cpu().numpy()
        touch0 = host(d.touch[w, s])
        R0 = int(self.resident[w])
        slack = C - R0
        q = self._lru_q[w]
        pb = self.page_bytes

        # maximal op segments of constant (in-cache, owning run): cold
        # cells key to -1, in-cache cells to their touch tick
        key = np.where(incache0, touch0, np.int64(-1))
        cuts = np.flatnonzero(np.diff(key)) + 1
        seg_lo = np.concatenate(([0], cuts))
        seg_hi = np.concatenate((cuts, [n]))

        evicted_pre = np.zeros(n, bool)   # evicted before their touch
        touch_front = 0
        qi = 0                            # victim stream cursor: run index
        roff = int(q[0][4]) if q else 0   # ... and scan offset within it
        rec = self._danger_rec            # shared-schedule leader run

        def note_in_op(vc):
            ej = vc - c0
            evicted_pre[ej[(ej >= 0) & (ej < n)]] = True

        def consume(k: int) -> int:
            """Consume k victims from the pre-op stream in tick order,
            applying eviction effects; returns the shortfall once the
            stream is exhausted."""
            nonlocal qi, roff
            while k > 0 and qi < len(q):
                run = q[qi]
                t0r, rg, col0, nr = run[0], run[1], run[2], run[3]
                if roff >= nr:
                    qi += 1
                    roff = int(q[qi][4]) if qi < len(q) else 0
                    continue
                dr = self.dirs[rg]
                cc0 = col0 + (int(dr.shift[w]) - run[5])
                a, b = cc0 + roff, cc0 + nr
                in_op = dr is d and a < c0 + n and b > c0
                if run[6] and not in_op:
                    # pristine, outside the op: a contiguous live prefix
                    take = min(k, nr - roff)
                    if rec is not None:
                        rec["events"].append((qi, np.arange(roff,
                                                            roff + take)))
                    self._evict_now(w, dr, np.arange(a, a + take))
                    k -= take
                    roff += take
                    continue
                live = (np.ones(b - a, bool) if run[6]
                        else host((dr.touch[w, a:b] == t0r)
                                  & dr.incache[w, a:b]))
                if in_op:
                    # cells of the op range already touched are the
                    # newest copies, never pre-op victims
                    opj = np.arange(a - c0, b - c0)
                    live &= ~((opj >= 0) & (opj < n) & (opj < touch_front))
                tot = int(live.sum())
                if tot <= k:
                    vc = np.flatnonzero(live) + a
                    if vc.size:
                        if rec is not None:
                            rec["events"].append((qi, vc - cc0))
                        self._evict_now(w, dr, vc)
                        if in_op:
                            note_in_op(vc)
                    k -= tot
                    roff = nr
                    continue
                cols, cut = dr.take_upto_row(
                    torch.as_tensor(live, device=dr.device), k)
                vc = cols + a
                if rec is not None:
                    rec["events"].append((qi, vc - cc0))
                self._evict_now(w, dr, vc)
                if in_op:
                    note_in_op(vc)
                roff += cut
                k = 0
            return k

        enters = 0
        ev_done = 0
        own_done = 0
        for j0, j1 in zip(seg_lo.tolist(), seg_hi.tolist()):
            if incache0[j0] and not evicted_pre[j0]:
                touch_front = j1          # stale touches: no enters
                continue
            # cold cells, or an in-cache segment whose prefix was already
            # evicted (the refetch cascade claims the whole segment)
            enters += j1 - j0
            target = enters - slack
            if target > ev_done:
                own_done += consume(target - ev_done)
                ev_done = target
            touch_front = j1

        # fetch misses: every cell invalid at its touch whose page charges
        miss = ~valid0 | evicted_pre
        if fetch_flag is not None:
            miss &= fetch_flag
        n_miss = int(miss.sum())
        if n_miss and self.protocol != IDEAL_PROTO:
            self.traffic.page_fetches += n_miss
            self.traffic.fetch_bytes += n_miss * pb

        # final plane state of the op range, then the op's own oldest
        # columns consumed once the stream ran dry (a prefix) evict through
        # _evict_now, reading their post-touch dirty state off the planes
        d.valid[w, s] = True
        d.incache[w, s] = True
        if is_write:
            d.dirty[w, s] = True
            d.maybe_dirty = True
            self._dirty_regions[w].add(region)
        else:
            d.dirty[w, s] = torch.as_tensor(dirty0 & ~evicted_pre,
                                            device=d.device)
        if own_done >= n:
            raise RuntimeError(f"refetch schedule consumed {own_done} of "
                               f"the op's own {n} pages")
        if rec is not None:
            rec.update(qi=qi, roff=roff, evicted_pre=evicted_pre,
                       enters=enters, own_done=own_done, n_miss=n_miss)
        if own_done:
            self._evict_now(w, d, np.arange(c0, c0 + own_done))

        # queue: drop fully-consumed front runs, advance the partial one,
        # append the op's own touch run (its consumed prefix starts dead)
        for _ in range(min(qi, len(q))):
            q.popleft()
        if q:
            if roff >= q[0][3]:       # cursor drained the run exactly
                q.popleft()
            else:
                q[0][4] = roff
        tick = self._q_append(w, region, c0, n, int(d.shift[w]))
        d.touch[w, s] = tick
        if own_done:
            q[-1][4] = own_done
        self.resident[w] += enters     # _evict_now debited every victim
        if int(self.resident[w]) != min(R0 + enters, C):
            raise RuntimeError(f"refetch schedule left worker {w} with "
                               f"{self.resident[w]} resident pages, not "
                               f"{min(R0 + enters, C)}")
        return n_miss

    _DANGER_SHARE_CELLS = 1 << 18

    def _danger_shared(self, rows: np.ndarray, d: RegionDirectory,
                       region: int, ga, lo: np.ndarray, hi: np.ndarray,
                       p_lo: np.ndarray, p_hi: np.ndarray, *,
                       is_write: bool) -> bool:
        """Resolve lockstep-isomorphic danger workers through ONE shared
        evict-then-refetch schedule.  The workers must have the same op
        geometry, the same pre-op valid/incache/dirty (and wprot) patterns
        over the op range, the same touch-run boundaries and structurally
        identical LRU queues, checked run by run until the guaranteed
        victim supply covers the op's demand.  When the check passes the
        leader replays once with its schedule recorded and the others
        apply it as batched plane ops with the per-worker charges
        replicated term for term; returns False (and the caller replays
        per worker) otherwise."""
        R = int(rows.size)
        w0 = int(rows[0])
        pw = self.page_words
        L = p_hi[rows] - p_lo[rows]
        n = int(L[0])
        if not (L == n).all() or n == 0:
            return False
        if is_write:
            # uniform page phase => uniform partial-page fetch mask
            if (not (lo[rows] % pw == int(lo[w0]) % pw).all()
                    or not (hi[rows] % pw == int(hi[w0]) % pw).all()
                    or not (hi[rows] - lo[rows]
                            == int(hi[w0]) - int(lo[w0])).all()):
                return False
        if not (self.resident[rows] == self.resident[w0]).all():
            return False
        qs = [self._lru_q[int(w)] for w in rows]
        qlen = len(qs[0])
        if any(len(q) != qlen for q in qs[1:]) or qlen == 0:
            return False
        if not (self._q_degraded[rows] == self._q_degraded[w0]).all():
            return False
        d.ensure_rows(p_lo[rows], p_hi[rows], rows)
        c0 = (p_lo[rows] - d.base[rows]).astype(np.int64)
        colmat = c0[:, None] + np.arange(n)[None, :]
        inc0, val0, dir0 = (d.cells(pl, rows, colmat)
                            for pl in (d.incache, d.valid, d.dirty))
        if ((inc0 != inc0[0]).any() or (val0 != val0[0]).any()
                or (dir0 != dir0[0]).any()):
            return False
        if n > 1:
            t0 = d.cells(d.touch, rows, colmat)
            if ((np.diff(t0, axis=1) != 0)
                    != (np.diff(t0[0]) != 0)[None, :]).any():
                return False
        wp_faults = 0
        if self._track_wprot:
            wp0 = d.cells(d.wprot, rows, colmat)
            if (wp0 != wp0[0]).any():
                return False
            wp_faults = int(wp0[0].sum())

        # queue walk: verify every run the schedule could consume.  The op
        # demands at most n victims; a run's guaranteed supply is its live
        # cells outside the op range, so once the cumulative supply
        # reaches n the schedule provably looks no further.
        cum = 0
        cells = n * R
        run_info = []               # per run: (region, members' cc0)
        for j in range(qlen):
            metas = [q[j] for q in qs]
            m0 = metas[0]
            rg, nr, off, pris = m0[1], m0[3], m0[4], m0[6]
            for mm in metas[1:]:
                if (mm[1] != rg or mm[3] != nr or mm[4] != off
                        or mm[6] != pris):
                    return False
            dr = self.dirs[rg]
            cc0 = np.array(
                [metas[i][2] + (int(dr.shift[rows[i]]) - metas[i][5])
                 for i in range(R)], np.int64)
            if rg == region and not ((cc0 - c0) == (cc0[0] - c0[0])).all():
                return False
            run_info.append((rg, cc0))
            ln = nr - off
            if ln <= 0:
                continue
            cells += ln * R
            if cells > self._DANGER_SHARE_CELLS:
                return False
            cm = cc0[:, None] + np.arange(off, nr)[None, :]
            dm = dr.cells(dr.dirty, rows, cm)
            if (dm != dm[0]).any():
                return False
            if rg == region:
                cols0 = cc0[0] + np.arange(off, nr)
                outside = (cols0 < c0[0]) | (cols0 >= c0[0] + n)
            else:
                outside = None
            if pris:
                cum += int(outside.sum()) if outside is not None else ln
            else:
                tks = np.array([metas[i][0] for i in range(R)], np.int64)
                lv = ((dr.cells(dr.touch, rows, cm) == tks[:, None])
                      & dr.cells(dr.incache, rows, cm))
                if (lv != lv[0]).any():
                    return False
                cum += int((lv[0] & outside).sum() if outside is not None
                           else lv[0].sum())
            if cum >= n:
                break

        # the leader runs the ordinary replay, recording the schedule
        self._danger_rec = rec = {"events": []}
        try:
            if is_write:
                self.write(w0, ga, int(lo[w0]), int(hi[w0]))
            else:
                self.read(w0, ga, int(lo[w0]), int(hi[w0]))
        finally:
            self._danger_rec = None
        self._danger_apply(rows, d, region, lo, hi, p_lo, p_hi, rec,
                           run_info, c0, colmat, dir0[0],
                           wp_faults, is_write=is_write)
        # the members resolve vectorized too (the leader's call counted
        # itself)
        self.stats["danger_vec_ops"] += R - 1
        self.stats["danger_shared_ops"] += R
        return True

    def _danger_apply(self, rows: np.ndarray, d: RegionDirectory,
                      region: int, lo, hi, p_lo, p_hi, rec: dict,
                      run_info, c0: np.ndarray, colmat: np.ndarray,
                      dirty0: np.ndarray, wp_faults: int, *,
                      is_write: bool):
        """Apply the leader's recorded schedule to the other isomorphic
        rows as batched plane ops, replicating the per-worker charge
        sequence term for term (see _danger_shared)."""
        m = rows[1:]
        R = int(m.size)
        cm_op = colmat[1:]
        n = int(p_hi[rows[0]] - p_lo[rows[0]])
        pb = self.page_bytes
        lat = self.cost.net_latency_s
        bwd = self.cost.net_bw_Bps
        op_cells = (d.ix(m)[:, None], d.ix(cm_op))

        if is_write:
            # write()'s pre-danger charges: instrumented stores, then
            # write faults (wprot cleared over the range)
            if self.model_mechanism and self.protocol == FINE_PROTO:
                self.clock[m] += ((int(hi[rows[0]]) - int(lo[rows[0]]))
                                  * self.instr_s_per_word)
            if self._track_wprot:
                self.clock[m] += wp_faults * self.fault_s
                d.wprot[op_cells] = False
            d.note_dirty(m, p_lo[m], p_hi[m])

        def evict_cols(dr: RegionDirectory, cols: np.ndarray):
            blk = (dr.ix(m)[:, None], dr.ix(cols))
            dm = host(dr.dirty[blk])
            db = int(dm[0].sum())
            if not (dm.sum(axis=1) == db).all():
                raise RuntimeError("shared danger schedule: rows are not "
                                   "isomorphic")
            if db:
                r_i, c_i = np.nonzero(dm)
                hot = (dr.ix(m[r_i]), dr.ix(cols[r_i, c_i]))
                dr.dirty[hot] = False
                self.traffic.writeback_bytes += db * pb * R
                self.clock[m] += (lat * db + db * pb / bwd)
                if self.chaos is not None:
                    self.clock[m] += self.chaos.retry_rows(m)
                if dr.wprot is not None:
                    dr.wprot[hot] = True
                # sharer invalidation is a proven no-op: shared danger
                # rows come from the independent set
            dr.valid[blk] = False
            dr.incache[blk] = False
            self.resident[m] -= cols.shape[1]

        for qi_ev, rel in rec["events"]:
            rg, cc0 = run_info[qi_ev]
            evict_cols(self.dirs[rg], cc0[1:][:, None] + rel[None, :])

        # fetch-miss traffic + the op's final plane state
        n_miss = rec["n_miss"]
        if n_miss:
            self.traffic.page_fetches += n_miss * R
            self.traffic.fetch_bytes += n_miss * pb * R
        d.valid[op_cells] = True
        d.incache[op_cells] = True
        if is_write:
            d.dirty[op_cells] = True
            d.maybe_dirty = True
            for w in m:
                self._dirty_regions[w].add(region)
        else:
            d.dirty[op_cells] = torch.as_tensor(
                dirty0 & ~rec["evicted_pre"], device=d.device)[None, :]
        own_done = rec["own_done"]
        if own_done:
            evict_cols(d, cm_op[:, :own_done])

        # queue cleanup + the op's own touch run, per row
        qi, roff = rec["qi"], rec["roff"]
        ticks = np.empty(R, np.int64)
        for i, w in enumerate(m):
            q = self._lru_q[w]
            for _ in range(min(qi, len(q))):
                q.popleft()
            if q:
                if roff >= q[0][3]:
                    q.popleft()
                else:
                    q[0][4] = roff
            ticks[i] = self._q_append(int(w), region, int(c0[1 + i]), n,
                                      int(d.shift[w]))
            if own_done:
                q[-1][4] = own_done
        d.touch[op_cells] = d.ix(ticks)[:, None]
        self.resident[m] += rec["enters"]
        if not (self.resident[m] == min(int(self.resident[rows[0]]),
                                        int(self.cache_pages))).all():
            raise RuntimeError("shared danger schedule: resident counts "
                               "diverged")

        # the op's fetch messages, once per worker (read/write charge
        # these after _danger_replay returns)
        if n_miss:
            self.clock[m] += self.cost.xfer_s(
                n_miss * pb, 2 * -(-n_miss // self.fetch_batch))
            if self.chaos is not None:
                self.clock[m] += self.chaos.retry_rows(m)

    def _danger_sig(self, w: int, d: RegionDirectory, lo, hi,
                    p_lo, p_hi, *, is_write: bool) -> tuple:
        """Per-row isomorphism-class key for ``_danger_subgroups``: op
        geometry, occupancy, op-range plane patterns and the LRU queue's
        run structure.  Equal keys only make candidates:
        ``_danger_shared`` re-verifies every cross-row condition."""
        pw = self.page_words
        p0, p1 = int(p_lo[w]), int(p_hi[w])
        n = p1 - p0
        s = d.sl(w, p0, p1)
        sig: list = [n, int(self.resident[w]), bool(self._q_degraded[w])]
        if is_write:
            sig += [int(lo[w]) % pw, int(hi[w]) % pw,
                    int(hi[w]) - int(lo[w])]
        planes = [d.incache[w, s], d.valid[w, s], d.dirty[w, s]]
        if self._track_wprot:
            planes.append(d.wprot[w, s])
        sig.append(torch.stack(planes).cpu().numpy().tobytes())
        if n > 1:
            sig.append((np.diff(host(d.touch[w, s])) != 0).tobytes())
        c0 = p0 - int(d.base[w])
        for _t0, rg, col0, nr, off, shift0, pris in self._lru_q[w]:
            cc = col0 + (int(self.dirs[rg].shift[w]) - shift0)
            sig.append((rg, nr, off, bool(pris),
                        cc - c0 if rg == d.region else -(1 << 30)))
        return tuple(sig)

    def _danger_subgroups(self, drows: np.ndarray, d: RegionDirectory,
                          ga, lo, hi, p_lo, p_hi, *,
                          is_write: bool) -> np.ndarray:
        """When the whole-group ``_danger_shared`` check fails, partition
        the danger rows by ``_danger_sig`` and let every class of >= 2 rows
        (short of the whole group) try the shared schedule on its own.
        Returns the rows left to replay per worker, ascending."""
        groups: Dict[tuple, List[int]] = {}
        d.ensure_rows(p_lo[drows], p_hi[drows], drows)
        for w in drows.tolist():
            groups.setdefault(self._danger_sig(w, d, lo, hi, p_lo, p_hi,
                                               is_write=is_write),
                              []).append(w)
        resid: List[int] = []
        for ws in groups.values():
            grp = np.asarray(ws, np.int64)
            if (2 <= grp.size < drows.size
                    and self._danger_shared(grp, d, d.region, ga, lo, hi,
                                            p_lo, p_hi,
                                            is_write=is_write)):
                self.stats["danger_subgroup_ops"] += int(grp.size)
                continue
            resid.extend(ws)
        resid.sort()
        return np.asarray(resid, np.int64)

    def _maybe_evict(self, w: int):
        """Watermark-triggered eviction: no per-op work unless the
        occupancy counter crossed ``cache_pages``."""
        if self.cache_pages is None or self.resident[w] <= self.cache_pages:
            return
        self._evict_cells(w, int(self.resident[w]) - self.cache_pages)

    # ------------------------------------------------------------------
    # per-worker reads / writes (interval API)
    # ------------------------------------------------------------------

    def read(self, w: int, ga: GasArray, lo: int, hi: int):
        region = self._region_of(ga.page_lo)
        p_lo = ga.page_lo + lo // self.page_words
        p_hi = ga.page_lo + (max(hi - 1, lo)) // self.page_words + 1
        if self.detect_races and not self._race_suspend:
            # the declared range: prefetch is not an access
            self._race_access(w, region, p_lo, p_hi, False)
        arr_end = ga.page_lo + -(-ga.n_elems // self.page_words)
        p_hi = max(min(p_hi + self.prefetch, arr_end), p_hi)  # prefetch
        if self.cache_pages is not None:
            d = self.dirs[region]
            d.ensure(w, p_lo, p_hi)
            s = d.sl(w, p_lo, p_hi)
            n = p_hi - p_lo
            n_enter = n - int(d.incache[w, s].sum())
            if self._danger(w, n_enter, n):
                if self.danger_mode == "vec" and self.cache_pages >= 1:
                    self.stats["danger_vec_ops"] += 1
                    n_miss = self._danger_replay(w, d, region, p_lo, p_hi,
                                                 None, is_write=False)
                else:
                    self.stats["danger_scalar_ops"] += 1
                    n_miss = 0
                    for p in range(p_lo, p_hi):
                        n_miss += self._touch_page_exact(w, d, p, fetch=True)
                if n_miss:
                    self._net(w, n_miss * self.page_bytes,
                              2 * -(-n_miss // self.fetch_batch))
                return
        self._fetch_range(w, region, p_lo, p_hi)
        self._maybe_evict(w)

    def write(self, w: int, ga: GasArray, lo: int, hi: int):
        region = self._region_of(ga.page_lo)
        p_lo = ga.page_lo + lo // self.page_words
        p_hi = ga.page_lo + (max(hi - 1, lo)) // self.page_words + 1
        if self.detect_races and not self._race_suspend:
            self._race_access(w, region, p_lo, p_hi, True)
        d = self.dirs[region]
        d.ensure(w, p_lo, p_hi)
        in_span = bool(self.spans[w])
        if not in_span:
            d.note_dirty(w, p_lo, p_hi)
        n_words = hi - lo

        # mechanism cost: instrumented stores (fine) / write faults (page)
        if self.model_mechanism and self.protocol == FINE_PROTO:
            self.clock[w] += n_words * self.instr_s_per_word
        if self._track_wprot:
            s = d.sl(w, p_lo, p_hi)
            n_faults = int(d.wprot[w, s].sum())
            self.clock[w] += n_faults * self.fault_s
            d.wprot[w, s] = False

        if self.cache_pages is not None and self.protocol != IDEAL_PROTO:
            s = d.sl(w, p_lo, p_hi)
            n = p_hi - p_lo
            n_enter0 = n - int(d.incache[w, s].sum())
            if self._danger(w, n_enter0, n):
                self._danger_write(w, ga, d, region, lo, hi, p_lo, p_hi,
                                   in_span)
                return

        # write-allocate: partial edge pages must be fetched; interior
        # full-page writes just become valid
        if self.protocol != IDEAL_PROTO:
            if p_hi - p_lo == 1:
                if n_words < self.page_words:
                    self._fetch_range(w, region, p_lo, p_lo + 1)
            else:
                if lo % self.page_words != 0:
                    self._fetch_range(w, region, p_lo, p_lo + 1)
                if hi % self.page_words != 0:
                    self._fetch_range(w, region, p_hi - 1, p_hi)
        s = d.sl(w, p_lo, p_hi)
        if d.touch is not None:
            n = p_hi - p_lo
            d.touch[w, s] = self._q_append(w, region, s.start, n,
                                           int(d.shift[w]))
            n_enter = n - int(d.incache[w, s].sum())
            if n_enter:
                d.incache[w, s] = True
                self.resident[w] += n_enter
        d.valid[w, s] = True

        if in_span:
            span = self.spans[w][-1]
            if span.plane:
                self._span_note(w, span, d, region, ga, lo, hi, p_lo, p_hi)
            else:
                self._span_touch_dict(span, ga, lo, hi, p_lo, p_hi)
        else:
            d.dirty[w, s] = True
            d.maybe_dirty = True
            self._dirty_regions[w].add(region)
        self._maybe_evict(w)

    @staticmethod
    def _span_touch_dict(span: _Span, ga, lo: int, hi: int, p_lo: int,
                         p_hi: int):
        """Merge one in-span write's per-page word intervals into a nested
        span's per-page dict."""
        for p in range(p_lo, p_hi):
            wlo, whi = ga.word_range_in_page(p, lo, hi)
            old = span.touched.get(p)
            span.touched[p] = ((min(wlo, old[0]), max(whi, old[1]))
                               if old else (wlo, whi))

    def _danger_write(self, w: int, ga, d: RegionDirectory, region: int,
                      lo: int, hi: int, p_lo: int, p_hi: int,
                      in_span: bool):
        """A danger-flagged write: the analytic refetch schedule outside
        spans (with the partial-page fetch mask), else the reference's
        exact per-page write-allocate + LRU walk (in-span writes touch few
        pages; their intervals land in the span planes in one note after
        the walk, which eviction never reads)."""
        pw = self.page_words
        if self.danger_mode == "vec" and self.cache_pages >= 1 \
                and not in_span:
            self.stats["danger_vec_ops"] += 1
            bw_ = (np.arange(p_lo, p_hi) - ga.page_lo) * pw
            partial = (np.minimum(hi - bw_, pw) - np.maximum(lo - bw_, 0)
                       < pw)
            n_miss = self._danger_replay(w, d, region, p_lo, p_hi, partial,
                                         is_write=True)
        else:
            self.stats["danger_scalar_ops"] += 1
            span = self.spans[w][-1] if in_span else None
            base = int(d.base[w])
            n_miss = 0
            for p in range(p_lo, p_hi):
                wlo, whi = ga.word_range_in_page(p, lo, hi)
                n_miss += self._touch_page_exact(w, d, p,
                                                 fetch=(whi - wlo) < pw)
                if not in_span:
                    d.dirty[w, p - base] = True
                    d.maybe_dirty = True
                    self._dirty_regions[w].add(region)
            if in_span:
                if span.plane:
                    self._span_note(w, span, d, region, ga, lo, hi, p_lo,
                                    p_hi)
                else:
                    self._span_touch_dict(span, ga, lo, hi, p_lo, p_hi)
        if n_miss:
            self._net(w, n_miss * self.page_bytes,
                      2 * -(-n_miss // self.fetch_batch))

    # ------------------------------------------------------------------
    # ordinary flush (page granularity in both protocols)
    # ------------------------------------------------------------------

    def _count_invalidations(self, n_inv: int):
        if n_inv:
            self.traffic.invalidations += n_inv
            self.traffic.control_msgs += n_inv
            self._chaos_invals(n_inv)

    def _chaos_invals(self, n_inv: int):
        """Invalidation messages charge no clock, so their losses are
        stats-only retransmissions on the chaos model's global counter:
        one call with a total equals any split of it."""
        if self.chaos is not None:
            self.chaos.inval_msgs(n_inv)

    def _invalidate_sharers(self, w: int, region: int, pages: np.ndarray):
        """Invalidate every other worker's valid copy of the sorted host
        page list ``pages``.  Small page sets gather the (rows x pages)
        block; wide ones gather only each row's window slice of the list,
        so work tracks actual coverage."""
        d = self.dirs[region]
        rows = d.overlap_rows(int(pages[0]), int(pages[-1]) + 1, exclude=w)
        if rows.size == 0:
            return
        if pages.size <= 64:
            hit, cols = d.gather_valid(rows, pages)
            n_inv = int(hit.sum())
            if n_inv:
                d.clear_valid_cells(rows, cols, hit)
                self._count_invalidations(n_inv)
            return
        pr, _, pc = _window_pairs(d, rows, pages)
        if not pr.size:
            return
        pr_t, pc_t = d.ix(pr), d.ix(pc)
        hit = d.valid[pr_t, pc_t]
        n_inv = int(hit.sum())
        if n_inv:
            d.valid[pr_t[hit], pc_t[hit]] = False
            self._count_invalidations(n_inv)

    def _flush_worker(self, w: int):
        """Write back + invalidate sharers for all of w's ordinary-dirty
        pages (the single-flusher path of acquire)."""
        regions = self._dirty_regions[w]
        if not regions:
            return
        for region in sorted(regions):
            d = self.dirs[region]
            cols = d.row_dirty_cols(w)
            d.clear_dirty_bounds(w)
            if cols.size == 0:
                continue
            # cells outside the row's window are never dirty
            d.dirty[w] = False
            if self.protocol == IDEAL_PROTO:
                continue
            n_dirty = cols.size
            self.traffic.writeback_bytes += n_dirty * self.page_bytes
            self._net(w, n_dirty * self.page_bytes,
                      -(-n_dirty // self.fetch_batch))   # batched writeback
            if d.wprot is not None:
                d.wprot[w, d.ix(cols)] = True     # re-arm write protection
            self._invalidate_sharers(w, region, d.base[w] + cols)
        regions.clear()

    def _flush_all_workers(self, mask: Optional[np.ndarray] = None):
        """Batched flush of every (masked) worker's ordinary-dirty pages,
        one pass per region that reproduces the sequential worker-order
        flush semantics analytically: for a page with dirty-worker set D
        (flushed in worker order) and initial valid set V, the sequential
        flushes produce ``|V \\ {d0}| + [|D|>1]*[d0 in V]`` invalidations
        and leave the page valid only at d0 when ``|D|==1``.  Pages under
        a single worker window have no sharer, so per-cell work is
        confined to multiply-covered pages.

        ``mask`` restricts the flush to a (W,) bool subset of workers
        (``span_all``'s hoisted flush): the unmasked rows' dirty cells and
        bounds stay as they are.  ``None`` flushes everyone (the barrier).
        The charges are the per-worker ``_flush_worker``'s term for term,
        so hoisting a worker's flush out of its acquire keeps clocks
        bit-equal.

        On 'fused' one ``phase_step`` launch reduces every dirty region
        (popcount, coverage stab, candidate words of the masked rows) from
        its bool dirty plane, and one copy (two past ``PHASE_STEP_PREFIX``
        candidate words) brings counts and candidates to the host; the
        other tiers reduce region by region (``popcount_rows``, then
        ``coverage_multi`` for the active rows' candidates).  Charging,
        wprot re-arm and the analytic invalidation stay on the host and
        are identical on every tier."""
        mrows = None if mask is None else np.nonzero(mask)[0]
        fused = None
        ji = 0
        if self.backend == "fused" and self.protocol != IDEAL_PROTO:
            cand = [d for d in self.dirs if d.maybe_dirty and d.cap > 0]
            if cand:
                fused = self._jit_flush_chain(cand, mask)
        for d in self.dirs:
            if not d.maybe_dirty:
                continue
            if fused is not None and d.cap > 0:
                nD_w, (w_idx, cols) = fused[0][ji], fused[1][ji]
                ji += 1
            else:
                nD_w = d.dirty_counts()
                w_idx = None
            if mask is not None:
                rest = int(nD_w[~mask].sum())
                nD_w = np.where(mask, nD_w, 0)
            total = int(nD_w.sum())
            d.maybe_dirty = False if mask is None else rest > 0
            d.clear_dirty_bounds(mrows)
            if total == 0:
                continue
            if self.protocol == IDEAL_PROTO:
                if mask is None:
                    d.dirty.zero_()
                else:
                    d.dirty[d.row_block(mrows)] = False
                continue
            active = np.nonzero(nD_w)[0]
            # per-(worker, region) writeback charge, as in the sequential
            # flush: one batched message group per worker window
            self.traffic.writeback_bytes += total * self.page_bytes
            msgs = -(-nD_w[active] // self.fetch_batch)
            self.clock[active] += (self.cost.net_latency_s * msgs
                                   + (nD_w[active] * self.page_bytes)
                                   / self.cost.net_bw_Bps)
            if self.chaos is not None:
                self.clock[active] += self.chaos.retry_rows(active)
            # the active rows only under a mask: one row gather and one
            # scatter a plane
            rb = None if mask is None else d.row_block(active)
            if d.wprot is not None:
                if rb is None:
                    torch.logical_or(d.wprot, d.dirty, out=d.wprot)  # re-arm
                else:
                    d.wprot[rb] = d.wprot[rb] | d.dirty[rb]
            if w_idx is None:
                w_idx, cols = self._shared_dirty_sweep(d, active)
            if w_idx.size:
                self._invalidate_shared_dirty(d, w_idx, cols)
            if rb is None:
                d.dirty.zero_()
            else:
                d.dirty[rb] = False
        for regions in (self._dirty_regions if mask is None
                        else (self._dirty_regions[w] for w in mrows)):
            regions.clear()

    def _shared_dirty_sweep(self, d: RegionDirectory, active: np.ndarray):
        """Unfused candidates: the dirty cells of the active rows inside
        the multiply-covered intervals, in worker-major, column-ascending
        order.  Index pairs are built on the host; one gather reads the
        dirty plane."""
        z = np.zeros(0, np.int64)
        starts, ends = d.shared_intervals()
        if not starts.size:
            return z, z
        w_l, c_l = [], []
        for w in active:
            b = int(d.base[w])
            e = b + int(d.length[w])
            i0 = int(np.searchsorted(ends, b, "right"))
            i1 = int(np.searchsorted(starts, e, "left"))
            for i in range(i0, i1):
                lo = max(int(starts[i]), b)
                hi = min(int(ends[i]), e)
                if lo < hi:
                    c_l.append(np.arange(lo - b, hi - b))
                    w_l.append(np.full(hi - lo, w, np.int64))
        if not c_l:
            return z, z
        w_idx = np.concatenate(w_l)
        cols = np.concatenate(c_l)
        hot = d.dirty[d.ix(w_idx), d.ix(cols)].cpu().numpy()
        return w_idx[hot], cols[hot]

    def _jit_flush_chain(self, cand, mask: Optional[np.ndarray] = None):
        """The fused flush as ONE ``phase_step`` launch over the dirty
        regions' bool planes and cached geometry tensors (no packing, no
        stacking), with the flush's (W,) worker ``mask`` as the kernel's
        (R, W) row mask, uploaded once.  Returns (host (R, W) per-row
        dirty counts, unmasked; per region the (row, column) host pairs
        of its shared-dirty candidates on the masked rows, row-major and
        column-ascending -- the sequential worker-major flush order), or
        None when page ids could overflow the kernel's int32 arithmetic --
        the caller then takes the kernel tier's
        ``popcount_rows``/``coverage_multi`` path."""
        R, W = len(cand), self.W
        nw_max = max(-(-int(d.cap) // 32) for d in cand)
        # page = base + col with col < nw_max*32 must stay below the
        # INT32_MAX pads
        if max(int(d.page_hi) for d in cand) + nw_max * 32 >= (1 << 31) - 1:
            return None
        rowmask = (None if mask is None else torch.as_tensor(
            np.broadcast_to(mask, (R, W)).copy(), device=cand[0].device))
        out = _ps.phase_step([d.dirty for d in cand],
                             [d.jit_geometry_tensor() for d in cand],
                             rowmask)
        self.stats["fused_dispatches"] += 1
        counts, key, word = _ps.read_phase_step(out, R, W)
        reg, rows, cols = _ps.candidate_cells(key, word, W)
        cut = np.searchsorted(reg, np.arange(R + 1))
        return counts, [(rows[a:b], cols[a:b])
                        for a, b in zip(cut[:-1], cut[1:])]

    def _invalidate_shared_dirty(self, d: RegionDirectory,
                                 w_idx: np.ndarray, cols: np.ndarray):
        """Apply the analytic sequential-flush invalidation to the dirty
        cells (host worker-major order) of multiply-covered pages.  The
        (row, page) pairs are gathered sparsely: each row sees only its
        window's slice of the page list."""
        pages = d.base[w_idx] + cols
        u, first, counts = np.unique(pages, return_index=True,
                                     return_counts=True)
        d0_rows = w_idx[first]                # min dirty worker per page
        pr, pu, pc = _window_pairs(d, d.overlap_rows(int(u[0]),
                                                     int(u[-1]) + 1), u)
        # one gather: the d0 cells, then every pair cell
        g = d.valid[d.ix(np.concatenate([d0_rows, pr])),
                    d.ix(np.concatenate([cols[first], pc]))].cpu().numpy()
        d0v = g[:u.size].astype(np.int64)
        val = g[u.size:]
        nV0 = np.bincount(pu[val], minlength=u.size)
        n_inv = int((nV0 - d0v + np.where(counts > 1, d0v, 0)).sum())
        self._count_invalidations(n_inv)
        # final valid state: keep only a sole dirty writer's copy
        keep = (counts == 1)[pu] & (pr == d0_rows[pu])
        hot = val & ~keep
        if hot.any():
            d.valid[d.ix(pr[hot]), d.ix(pc[hot])] = False

    # ------------------------------------------------------------------
    # spans + notice replay
    # ------------------------------------------------------------------

    def _span_note(self, w: int, span: _Span, d: RegionDirectory,
                   region: int, ga, lo: int, hi: int, p_lo: int, p_hi: int):
        """Record one in-span write's per-page word intervals in the span
        planes (plane-tracked spans)."""
        b = span.bounds.get(region)
        if b is None:
            span.bounds[region] = [p_lo, p_hi]
        else:
            b[0] = min(b[0], p_lo)
            b[1] = max(b[1], p_hi)
        if p_hi - p_lo == 1:
            wlo, whi = ga.word_range_in_page(p_lo, lo, hi)
            d.span_note(w, p_lo, p_hi, wlo, whi)
            return
        bw_ = (np.arange(p_lo, p_hi) - ga.page_lo) * self.page_words
        d.span_note(w, p_lo, p_hi, np.maximum(lo - bw_, 0),
                    np.minimum(hi - bw_, self.page_words))

    def _replay_invalidate(self, w: int, pages: np.ndarray, rearm: bool):
        """Page-protocol notice replay: invalidate w's valid copies of
        ``pages`` (grouped per region), returning the number invalidated."""
        total = 0
        regions = np.searchsorted(self._region_starts_np, pages, "right") - 1
        for r in np.unique(regions):
            d = self.dirs[int(r)]
            if d.base[w] < 0:
                continue
            cols = pages[regions == r] - d.base[w]
            cols = cols[(cols >= 0) & (cols < d.length[w])]
            if not cols.size:
                continue
            cols_t = d.ix(cols)
            hot = cols_t[d.valid[w, cols_t]]
            n = int(hot.numel())
            if n:
                d.valid[w, hot] = False
                if rearm and d.wprot is not None:
                    d.wprot[w, hot] = True
                total += n
        return total

    def acquire(self, w: int, lock_id: int):
        lk = self.locks.setdefault(lock_id, _Lock(self.W))
        self._flush_worker(w)                       # RegC rule 1
        self._net(w, 64, 2)
        self.traffic.control_msgs += 2
        self.clock[w] = max(self.clock[w], lk.last_release_time)
        # RegC rule 2, notices coalesced per page
        u, lo_u, hi_u = lk.log.pending(int(lk.seen[w]), lk.version)
        if u.size:
            if self.protocol == FINE_PROTO:
                nbytes = (hi_u - lo_u) * _WORD + self.page_words // 8
                tot = int(nbytes.sum())
                self.traffic.diff_bytes += tot
                self.clock[w] += (self.cost.net_latency_s * u.size
                                  + tot / self.cost.net_bw_Bps)
                if self.chaos is not None:
                    self.clock[w] += self.chaos.retry1(w)
            else:
                n_inv = self._replay_invalidate(
                    w, u, rearm=self.model_mechanism)
                self.traffic.invalidations += n_inv
                self.traffic.control_msgs += int(u.size)
                self._chaos_invals(n_inv)
        lk.seen[w] = lk.version
        if self.detect_races and not self._race_suspend:
            # acquire happens after every release of the lock
            np.maximum(self.race_vc[w], lk.race_vc, out=self.race_vc[w])
        self.spans[w].append(_Span(lock_id, plane=not self.spans[w]))

    def _span_harvest(self, w: int, span: _Span):
        """The release-publish payload of ``span`` — host (pages, los,
        his) ascending by page — from the span planes (depth-1 spans;
        cells reset) or the per-page dict (nested spans).  Region order is
        page order, so multi-region harvests concatenate sorted."""
        if span.plane:
            parts = [self.dirs[region].span_harvest(w, lo_b, hi_b)
                     for region, (lo_b, hi_b) in sorted(span.bounds.items())]
            if not parts:
                z = np.zeros(0, np.int64)
                return z, z, z
            if len(parts) == 1:
                return parts[0]
            return tuple(np.concatenate([p[i] for p in parts])
                         for i in range(3))
        items = sorted(span.touched.items())
        return (np.array([p for p, _ in items], np.int64),
                np.array([iv[0] for _, iv in items], np.int64),
                np.array([iv[1] for _, iv in items], np.int64))

    def _span_publish(self, w: int, lk: _Lock, pages: np.ndarray,
                      los: np.ndarray, his: np.ndarray):
        """Release-time publish: traffic + ONE batched clock charge for
        the span's coalesced page intervals, then one log append for the
        whole version."""
        n = int(pages.size)
        if n:
            if self.protocol == FINE_PROTO:
                tot = (int((his - los).sum()) * _WORD
                       + n * (self.page_words // 8))
                self.traffic.diff_bytes += tot
            else:
                tot = n * self.page_bytes
                self.traffic.writeback_bytes += tot
            self.clock[w] += (self.cost.net_latency_s * n
                              + tot / self.cost.net_bw_Bps)
            if self.chaos is not None:
                self.clock[w] += self.chaos.retry1(w)
        lk.log.append_version(pages, los, his)
        lk.version += 1
        lk.seen[w] = lk.version

    def release(self, w: int, lock_id: int):
        span = self.spans[w].pop()
        if span.lock != lock_id:
            raise RuntimeError(f"unbalanced lock release: worker {w} "
                               f"releases {lock_id}, holds {span.lock}")
        lk = self.locks[lock_id]
        if self.protocol != IDEAL_PROTO:
            self._span_publish(w, lk, *self._span_harvest(w, span))
        elif span.plane:
            # IDEAL publishes nothing, but the planes must reset
            for region, (lo_b, hi_b) in span.bounds.items():
                self.dirs[region].span_harvest(w, lo_b, hi_b)
        self._net(w, 64, 1)
        self.traffic.control_msgs += 1
        lk.last_release_time = self.clock[w]
        if self.detect_races and not self._race_suspend:
            # publish the releaser's view, then open a new epoch
            np.maximum(lk.race_vc, self.race_vc[w], out=lk.race_vc)
            self.race_vc[w, w] += 1

    class _SpanCtx:
        def __init__(self, rt, w, lock_id):
            self.rt, self.w, self.lock_id = rt, w, lock_id

        def __enter__(self):
            self.rt.acquire(self.w, self.lock_id)

        def __exit__(self, *exc):
            self.rt.release(self.w, self.lock_id)
            return False

    def span(self, w: int, lock_id: int):
        return self._SpanCtx(self, w, lock_id)

    # ------------------------------------------------------------------
    # race detection (detect_races mode; a pure observer: it touches only
    # the vector clocks, the lock clocks, the race planes and the flagged
    # set, never traffic, clocks, windows beyond what the op itself
    # ensures, or a protocol plane)
    # ------------------------------------------------------------------

    def _race_record(self, pages, a, b, kind: str):
        """Add the races (pages[i], a[i], b[i], kind), canonical a < b,
        counting each new one once in ``stats['race_' + kind]``."""
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        for t in zip(np.asarray(pages).tolist(), lo.tolist(), hi.tolist()):
            t = (*t, kind)
            if t not in self.races:
                self.races.add(t)
                self.stats["race_" + kind] += 1

    def _race_check(self, d: RegionDirectory, ws: np.ndarray,
                    p_lo: np.ndarray, p_hi: np.ndarray, views: np.ndarray,
                    is_write: bool):
        """Flag every recorded epoch over worker ws[i]'s declared pages
        [p_lo[i], p_hi[i]) that its view views[i] does not order: the
        write plane (kind 'ww' for a write, 'rw' for a read), and for a
        write the read plane too ('rw').  One batched gather for all."""
        planes = (True, False) if is_write else (True,)
        hits = d.race_hits_many(p_lo, p_hi, views, planes)
        for plane, (i, u, pages) in zip(planes, hits):
            if pages.size:
                self._race_record(pages, ws[i], u,
                                  "ww" if plane and is_write else "rw")

    def _race_access(self, w: int, region: int, p_lo: int, p_hi: int,
                     is_write: bool):
        """Check-then-record one worker's declared page range: the scalar
        hook of ``read``/``write`` outside the batched calls."""
        d = self.dirs[region]
        d.ensure_race()
        d.ensure(w, p_lo, p_hi)
        self._race_check(d, np.array([w]), np.array([p_lo]),
                         np.array([p_hi]), self.race_vc[[w]], is_write)
        d.race_note(w, p_lo, p_hi, int(self.race_vc[w, w]), is_write)

    def _race_pairs(self, lo_a, hi_a, lo_b, hi_b, keep: np.ndarray):
        """(pages, i, k) of every page in both [lo_a[i], hi_a[i]) and
        [lo_b[k], hi_b[k]) over the (i, k) pairs that ``keep`` (an (n, n)
        host mask) admits."""
        ov_lo = np.maximum(lo_a[:, None], lo_b[None, :])
        ov_hi = np.minimum(hi_a[:, None], hi_b[None, :])
        i, k = np.nonzero((ov_hi > ov_lo) & keep)
        L = ov_hi[i, k] - ov_lo[i, k]
        ix = np.repeat(np.arange(i.size), L)
        pages = ov_lo[i, k][ix] + (np.arange(ix.size)
                                   - np.repeat(np.cumsum(L) - L, L))
        return pages, i[ix], k[ix]

    def _race_pages(self, ga, lo: np.ndarray, hi: np.ndarray):
        pw = self.page_words
        return (ga.page_lo + lo // pw,
                ga.page_lo + np.maximum(hi - 1, lo) // pw + 1)

    def _race_op_all(self, ga, lo: np.ndarray, hi: np.ndarray,
                     is_write: bool):
        """Batched detection of one phase op across all workers, with the
        result of the reference's per-worker check-then-record walk.

        Inside one op no clock moves, and every other worker's view of w
        lies below w's own epoch (``race_vc[u][w] < race_vc[w][w]``, kept
        by release and barrier), so a note made in the op fires for every
        later worker that overlaps it.  The walk's result is therefore
        each worker's hits against the planes as they stood before the op,
        under its own view, plus, in a write op, every pair of distinct
        workers whose write ranges overlap, as 'ww' (a read op never
        changes the write plane, a write op never the read plane).  The
        first part runs only when the host screen (recorded maxima against
        the smallest view) says a cell could fire: one batched gather.
        The phase's ops have ensured every declared range."""
        region = self._region_of(ga.page_lo)
        d = self.dirs[region]
        p_lo, p_hi = self._race_pages(ga, lo, hi)
        vc = self.race_vc
        cross = False
        if d.race_maxw is not None:
            vcmin = vc.min(axis=0)
            cross = bool((d.race_maxw > vcmin).any())
            if is_write and not cross:
                cross = bool((d.race_maxr > vcmin).any())
        d.ensure_race()
        if cross:
            self._race_check(d, self._rows_all, p_lo, p_hi, vc, is_write)
        if is_write:
            ids = self._rows_all
            pages, i, k = self._race_pairs(p_lo, p_hi, p_lo, p_hi,
                                           ids[:, None] < ids[None, :])
            if pages.size:
                self._race_record(pages, i, k, "ww")
        d.race_note_rows(self._rows_all, p_lo, p_hi, vc.diagonal(),
                         is_write)

    def _race_phase_all(self, reads, writes):
        """End-of-phase detection over the declared op ranges, op by op:
        clocks are static inside a phase and the page-granular race set
        does not depend on the order of the walk, so this one pass covers
        every engine path of the phase (batched rows, danger rows, shared
        schedules, residual replays) exactly once."""
        for ga, lo, hi in reads:
            self._race_op_all(ga, lo, hi, False)
        for ga, lo, hi in writes:
            self._race_op_all(ga, lo, hi, True)

    def _race_span_all(self, rows: np.ndarray, locks: np.ndarray,
                       reads, writes):
        """End-of-``span_all`` detection, with the result of the
        reference's walk of each lock group's grant chain (members
        ascending: join the lock's clock, check-then-record each op,
        publish, open a new epoch).

        A member's view is a prefix join along its lock's chain (the
        lock's clock, then the earlier members' clocks), so every note of
        an earlier member of its group is ordered, and no note of another
        group in the same call is (groups hold distinct locks and disjoint
        rows).  The walk's result is each member's hits against the planes
        as they stood before the call, under its view, plus every
        overlapping pair of accesses by members of distinct groups that
        is not read/read: one batched gather per op, host pair sweeps,
        one scatter per region for the notes.  The call's own ops have
        ensured every declared range (reads the prefetch-extended one),
        so no window grows here, unlike the scalar hook, which runs
        before its op."""
        vc = self.race_vc
        for lk_id in np.unique(locks[rows]):
            lk = self.locks[int(lk_id)]
            grp = rows[locks[rows] == lk_id]
            chain = np.maximum.accumulate(
                np.concatenate([lk.race_vc[None, :], vc[grp]]), axis=0)[1:]
            vc[grp] = chain
            lk.race_vc = chain[-1].copy()
        ops = [(ga, *self._race_pages(ga, lo[rows], hi[rows]), False)
               for ga, lo, hi in reads]
        ops += [(ga, *self._race_pages(ga, lo[rows], hi[rows]), True)
                for ga, lo, hi in writes]
        views = vc[rows]
        for ga, p_lo, p_hi, is_write in ops:
            d = self.dirs[self._region_of(ga.page_lo)]
            d.ensure_race()
            self._race_check(d, rows, p_lo, p_hi, views, is_write)
        grp = locks[rows]
        other = grp[:, None] != grp[None, :]
        for a, (_, lo_a, hi_a, wa) in enumerate(ops):
            for _, lo_b, hi_b, wb in ops[a:]:
                if not (wa or wb):
                    continue
                pages, i, k = self._race_pairs(lo_a, hi_a, lo_b, hi_b,
                                               other)
                if pages.size:
                    self._race_record(pages, rows[i], rows[k],
                                      "ww" if wa and wb else "rw")
        epochs = vc[rows, rows]
        notes: Dict[int, list] = {}
        for ga, p_lo, p_hi, is_write in ops:
            notes.setdefault(self._region_of(ga.page_lo), []).append(
                (np.full(rows.size, 0 if is_write else 1), p_lo, p_hi))
        for region, parts in notes.items():
            planes, p_lo, p_hi = (np.concatenate(c) for c in zip(*parts))
            self.dirs[region].race_note_cells(
                planes, np.tile(rows, len(parts)), p_lo, p_hi,
                np.tile(epochs, len(parts)))
        vc[rows, rows] += 1

    @property
    def race_counts(self) -> Dict[str, int]:
        return {"race_ww": self.stats["race_ww"],
                "race_rw": self.stats["race_rw"]}

    # ------------------------------------------------------------------
    # SPMD phases
    # ------------------------------------------------------------------

    def phase(self, w: int, reads=(), writes=(), *, flops: float = 0.0,
              mem_bytes: float = 0.0, seconds: float = 0.0,
              instr_words: float = 0.0):
        """One worker-phase: interval reads, then interval writes, then
        the modeled compute + instrumented stores.  ``reads``/``writes``
        are sequences of ``(ga, lo, hi)``.  The per-worker path that
        ``phase_all`` batches over the worker axis."""
        for ga, lo, hi in reads:
            self.read(w, ga, lo, hi)
        for ga, lo, hi in writes:
            self.write(w, ga, lo, hi)
        if flops or mem_bytes or seconds:
            self.compute(w, flops=flops, mem_bytes=mem_bytes, seconds=seconds)
        if instr_words:
            self.instr_stores(w, instr_words)

    def _w_arr(self, v) -> np.ndarray:
        return np.broadcast_to(np.asarray(v, np.int64), (self.W,))

    def _page_range_all(self, ga, lo: np.ndarray, hi: np.ndarray, *,
                        prefetch: bool):
        pw = self.page_words
        p_lo = ga.page_lo + lo // pw
        p_hi = ga.page_lo + np.maximum(hi - 1, lo) // pw + 1
        if prefetch:
            arr_end = ga.page_lo + -(-ga.n_elems // pw)
            p_hi = np.maximum(np.minimum(p_hi + self.prefetch, arr_end), p_hi)
        return self._region_of(int(ga.page_lo)), p_lo, p_hi

    def _may_evict_mask(self, ranges) -> Optional[np.ndarray]:
        """Per-worker eviction-possibility upper bound for one phase: a
        page can newly occupy a cache slot only if it is out of cache at
        phase start and lies in a declared range, so ``resident + sum over
        ops of (range length - in-cache count)`` bounds each worker's peak
        occupancy.  None when no worker can cross the watermark."""
        if self.cache_pages is None:
            return None
        quick = self.resident.copy()
        for region, p_lo, p_hi in ranges:
            quick += p_hi - p_lo
        if (quick <= self.cache_pages).all():
            return None            # even all-cold ranges fit: no gathers
        ub = self.resident.copy()
        for region, p_lo, p_hi in ranges:
            d = self.dirs[region]
            ub += (p_hi - p_lo) - d.count_range(d.incache, p_lo, p_hi)
        may = ub > self.cache_pages
        return may if may.any() else None

    def _residual_workers(self, rranges, wranges,
                          may: np.ndarray) -> np.ndarray:
        """Window-disjointness analysis: which workers' phase executions
        can interact through eviction.  Within a phase the only
        cross-worker effect is an eviction writeback invalidating another
        worker's valid copy; an evictor's dirty victims lie inside its
        dirty bounds (widened by this phase's write ranges), and another
        worker sees the writeback only if those pages meet its reach
        (window plus declared ranges).  Workers in no such intersection
        run batched; the returned mask marks the rest, which replay in
        tick order."""
        resid = np.zeros(self.W, bool)

        def hull(ranges):
            out: Dict[int, list] = {}
            for region, p_lo, p_hi in ranges:
                r = out.get(region)
                if r is None:
                    out[region] = [p_lo.copy(), p_hi.copy()]
                else:
                    np.minimum(r[0], p_lo, out=r[0])
                    np.maximum(r[1], p_hi, out=r[1])
            return out

        reach = hull(rranges + wranges)
        wr = hull(wranges)
        imax = np.iinfo(np.int64).max
        imin = np.iinfo(np.int64).min
        for ri, d in enumerate(self.dirs):
            dlo, dhi = d.dirty_lo, d.dirty_hi
            if ri in wr:
                dlo = np.minimum(dlo, wr[ri][0])
                dhi = np.maximum(dhi, wr[ri][1])
            e = may & (dlo < dhi)
            if not e.any():
                continue
            live = d.base >= 0
            rlo = np.where(live, d.base, imax)
            rhi = np.where(live, d.base + d.length, imin)
            if ri in reach:
                rlo = np.minimum(rlo, reach[ri][0])
                rhi = np.maximum(rhi, reach[ri][1])
                live = np.ones(self.W, bool)
            E = np.nonzero(e)[0]
            M = ((rlo[None, :] < dhi[E][:, None])
                 & (rhi[None, :] > dlo[E][:, None]) & live[None, :])
            M[np.arange(E.size), E] = False
            if M.any():
                ei, vi = np.nonzero(M)
                resid[E[ei]] = True
                resid[vi] = True
        return resid

    def _op_danger_split(self, d: RegionDirectory, ga, lo, hi, p_lo, p_hi,
                         rows: np.ndarray, may: np.ndarray, *,
                         is_write: bool) -> np.ndarray:
        """Per-op ``_danger`` screen for the batched path: workers whose op
        could evict a still-cached page of its own range before touching
        it resolve THIS op through ``read``/``write`` (the refetch
        schedule, shared across isomorphic rows where possible); the rest
        stay batched.  Exact because the rows are proven independent.
        Returns the rows that stay batched."""
        if self.protocol == IDEAL_PROTO:
            return rows
        L = p_hi - p_lo
        cand = may[rows] & (self.resident[rows] + L[rows] > self.cache_pages)
        if not cand.any():
            return rows
        crows = rows[cand]
        n_in = d.count_range(d.incache, p_lo[crows], p_hi[crows], rows=crows)
        n_enter = L[crows] - n_in
        danger = (n_enter < L[crows]) & (
            self.resident[crows] + n_enter > self.cache_pages)
        if not danger.any():
            return rows
        drows = crows[danger]
        self.stats["danger_ops"] += int(drows.size)
        shareable = (drows.size >= 2 and self.danger_mode == "vec"
                     and self.cache_pages >= 1)
        if not (shareable
                and self._danger_shared(drows, d, d.region, ga, lo, hi,
                                        p_lo, p_hi, is_write=is_write)):
            # a group that failed the whole-group check may still hold a
            # lockstep subgroup
            resid = (self._danger_subgroups(drows, d, ga, lo, hi,
                                            p_lo, p_hi, is_write=is_write)
                     if shareable and drows.size >= 3 else drows)
            op = self.write if is_write else self.read
            for w in resid:
                op(int(w), ga, int(lo[w]), int(hi[w]))
        keep = np.ones(rows.size, bool)
        keep[np.nonzero(cand)[0][danger]] = False
        return rows[keep]

    def _evict_rows_batch(self, rows: np.ndarray):
        """Watermark eviction for ``rows`` after a batched op: each worker
        over the watermark evicts its least-recently-touched pages run by
        run from its queue (the victims and per-run charges of
        ``_evict_cells``), but rows whose front runs cover the same column
        span apply liveness, segment-LRU selection and plane updates as
        single 2D ops (``run_live``/``lru_take``/``evict_rows``).  Only
        called for workers proven independent, so the sharer-invalidation
        step is skipped as a no-op."""
        if rows.size == 0 or self.cache_pages is None:
            return
        k = self.resident[rows] - self.cache_pages
        over = k > 0
        if not over.any():
            return
        rows = rows[over]
        k = k[over].astype(np.int64)
        charge = self.protocol != IDEAL_PROTO
        while rows.size:
            if rows.size < 4:
                for w, kw in zip(rows, k):
                    self._evict_cells(int(w), int(kw))
                return
            self.stats["evict_batch_rounds"] += 1
            # one front run per needy worker, grouped by column span
            groups: Dict[Tuple[int, int, int, bool], list] = {}
            bts = np.empty(rows.size, np.int64)
            for i, w in enumerate(rows):
                t0, region, col0, n, off, shift0, pris = self._lru_q[w][0]
                d = self.dirs[region]
                c0 = col0 + (int(d.shift[w]) - shift0)
                bts[i] = t0
                groups.setdefault((region, c0 + off, n - off, pris),
                                  []).append(i)
            keep_rows, keep_k = [], []
            for (region, start, length, pris), idxs in groups.items():
                idxs = np.asarray(idxs, np.int64)
                R, kk = rows[idxs], k[idxs]
                d = self.dirs[region]
                if R.size < 4:
                    for w, kw in zip(R, kk):
                        self._evict_cells(int(w), int(kw))
                    continue
                if pris:
                    live = None
                    tot = np.full(R.size, length, np.int64)
                else:
                    live = d.run_live(R, start, length, bts[idxs])
                    tot = live.sum(dim=1).cpu().numpy()
                part = kk < tot
                for si in (np.nonzero(~part)[0], np.nonzero(part)[0]):
                    if si.size == 0:
                        continue
                    is_part = bool(part[si[0]])
                    whole = si.size == R.size
                    Rs, ks = R[si], kk[si]
                    tots = tot[si]
                    fully = pris or bool((tots == length).all())
                    # segment-LRU selection only where the run outlives the
                    # demand; whole-run and prefix takes of fully-live
                    # runs skip masks
                    span = length
                    if not is_part:
                        take = (None if fully
                                else live if whole else live[d.ix(si)])
                    elif pris and int(ks.min()) == int(ks.max()):
                        span = int(ks[0])      # uniform prefix: short span
                        take = None
                    elif pris:
                        take = (torch.arange(length, device=d.device)[None]
                                < d.ix(ks)[:, None])
                    else:
                        lv = live if whole else live[d.ix(si)]
                        take = d.lru_take(lv, ks, tots)
                    db = d.evict_rows(Rs, start, span, take,
                                      set_wprot=charge)
                    if charge and db.any():
                        self.traffic.writeback_bytes += (int(db.sum())
                                                         * self.page_bytes)
                        hit = db > 0
                        self.clock[Rs[hit]] += (
                            self.cost.net_latency_s * db[hit]
                            + db[hit] * self.page_bytes
                            / self.cost.net_bw_Bps)
                        if self.chaos is not None:
                            self.clock[Rs[hit]] += self.chaos.retry_rows(
                                Rs[hit])
                    if is_part:
                        # advance each run past its last taken cell
                        self.resident[Rs] -= ks
                        if fully:          # columnar take: cutoff is k
                            last = ks - 1
                        else:
                            last = (take.shape[1] - 1 - torch.argmax(
                                torch.flip(take, dims=[1]).to(torch.int8),
                                dim=1)).cpu().numpy()
                        for i, w in enumerate(Rs):
                            self._lru_q[w][0][4] += int(last[i]) + 1
                    else:
                        self.resident[Rs] -= tots
                        for w in Rs:
                            self._lru_q[w].popleft()
                        rem = ks - tots
                        m = rem > 0
                        if m.any():
                            keep_rows.append(Rs[m])
                            keep_k.append(rem[m])
            if not keep_rows:
                return
            rows = np.concatenate(keep_rows)
            k = np.concatenate(keep_k)
            # leftovers concatenate in group order: restore the ascending
            # row order every plane primitive assumes
            order = np.argsort(rows)
            rows = rows[order]
            k = k[order]

    def _fetch_range_all(self, region: int, p_lo: np.ndarray,
                         p_hi: np.ndarray, rows: np.ndarray):
        """Vectorized ``_fetch_range`` over ``rows``: identical per-worker
        traffic and clock charges.  Dense (R, Lmax) gather/scatter
        matrices for many narrow intervals; otherwise rows group by their
        (window-relative start, length) and each group is one 2D slice
        op."""
        d = self.dirs[region]
        d.ensure_rows(p_lo, p_hi, rows)
        L = p_hi - p_lo
        if use_dense(rows.size, int(L.max())):
            self._fetch_dense(d, region, p_lo, p_hi, rows)
            return
        c0 = p_lo - d.base[rows]
        uk, inv = np.unique(np.stack([c0, L], axis=1), axis=0,
                            return_inverse=True)
        inv = inv.reshape(-1)
        for g in range(uk.shape[0]):
            self._fetch_uniform(d, region, rows[inv == g], int(uk[g, 0]),
                                int(uk[g, 1]))

    def _charge_misses(self, rows: np.ndarray, n_miss: np.ndarray):
        """Fetch charges of one batched op: ``n_miss`` (aligned with
        ``rows``) pages per worker, in ``_fetch_range``'s expression."""
        tot_miss = int(n_miss.sum())
        if tot_miss and self.protocol != IDEAL_PROTO:
            self.traffic.page_fetches += tot_miss
            self.traffic.fetch_bytes += tot_miss * self.page_bytes
            n_req = -(-n_miss // self.fetch_batch)
            t = (self.cost.net_latency_s * (2 * n_req)
                 + (n_miss * self.page_bytes) / self.cost.net_bw_Bps)
            hit = n_miss > 0
            self.clock[rows[hit]] += t[hit]
            if self.chaos is not None:
                self.clock[rows[hit]] += self.chaos.retry_rows(rows[hit])
        return tot_miss

    def _touch_runs(self, d: RegionDirectory, region: int,
                    rows: np.ndarray, c0, n) -> np.ndarray:
        """Append one touch run per row (columns [c0[i], c0[i]+n[i]) of
        row rows[i]; scalars broadcast) and return the rows' fresh ticks,
        host int64."""
        c0 = np.broadcast_to(c0, rows.shape)
        n = np.broadcast_to(n, rows.shape)
        shifts = d.shift[rows]
        return np.array([self._q_append(int(w), region, int(c0[i]),
                                        int(n[i]), int(shifts[i]))
                         for i, w in enumerate(rows)], np.int64)

    def _touch_block(self, d: RegionDirectory, region: int,
                     rows: np.ndarray, rb, s: slice, c0: int, n: int):
        """Touch-run bookkeeping of a uniform-span group: fresh ticks on
        columns ``s`` of ``rows`` (row indexer ``rb``), which enter the
        cache."""
        d.touch[rb, s] = d.ix(self._touch_runs(d, region, rows, c0, n))[:,
                                                                       None]
        n_enter = n - d.incache[rb, s].sum(dim=1).cpu().numpy()
        d.incache[rb, s] = True
        self.resident[rows] += n_enter

    def _touch_cells(self, d: RegionDirectory, region: int,
                     rows: np.ndarray, cols: np.ndarray, mask: np.ndarray,
                     n: np.ndarray):
        """Touch-run bookkeeping of a dense group: fresh ticks on the
        ``mask`` cells of the (R, Lmax) column matrix ``cols``, which
        enter the cache."""
        t0 = self._touch_runs(d, region, rows, cols[:, 0], n)
        ri, ci = np.nonzero(mask)
        d.touch[d.ix(rows[ri]), d.ix(cols[ri, ci])] = d.ix(t0[ri])
        isub = d.cells(d.incache, rows, np.where(mask, cols, 0)) & mask
        ri, ci = np.nonzero(mask & ~isub)
        if ri.size:
            d.incache[d.ix(rows[ri]), d.ix(cols[ri, ci])] = True
        self.resident[rows] += n - isub.sum(axis=1)

    def _fetch_uniform(self, d: RegionDirectory, region: int,
                       rows: np.ndarray, c0: int, n: int):
        """One uniform-span fetch group: all ``rows`` fetch columns
        [c0, c0+n) of their windows — 2D slice ops, no gather."""
        s = slice(c0, c0 + n)
        rb = d.row_block(rows)
        n_miss = n - d.valid[rb, s].sum(dim=1).cpu().numpy()
        if d.touch is not None:
            self._touch_block(d, region, rows, rb, s, c0, n)
        if self._charge_misses(rows, n_miss):
            d.valid[rb, s] = True

    def _fetch_dense(self, d: RegionDirectory, region: int,
                     p_lo: np.ndarray, p_hi: np.ndarray, rows: np.ndarray):
        cols, mask = d.range_cols(p_lo, p_hi, rows)
        vsub = d.cells(d.valid, rows, np.where(mask, cols, 0)) & mask
        n_miss = (p_hi - p_lo) - vsub.sum(axis=1)
        if d.touch is not None:
            self._touch_cells(d, region, rows, cols, mask, p_hi - p_lo)
        if self._charge_misses(rows, n_miss):
            ri, ci = np.nonzero(mask & ~vsub)
            d.valid[d.ix(rows[ri]), d.ix(cols[ri, ci])] = True

    def _read_all(self, ga, lo: np.ndarray, hi: np.ndarray,
                  rows: Optional[np.ndarray] = None,
                  may: Optional[np.ndarray] = None):
        """One batched read op over ``rows`` (default all); with ``may``
        (the phase's eviction mask) the danger screen runs first and the
        op ends in watermark eviction."""
        region, p_lo, p_hi = self._page_range_all(ga, lo, hi, prefetch=True)
        rows = self._rows_all if rows is None else rows
        if may is not None:
            rows = self._op_danger_split(self.dirs[region], ga, lo, hi,
                                         p_lo, p_hi, rows, may,
                                         is_write=False)
        if rows.size:
            self._fetch_range_all(region, p_lo[rows], p_hi[rows], rows)
        if may is not None:
            self._evict_rows_batch(rows)

    def _write_all(self, ga, lo: np.ndarray, hi: np.ndarray,
                   rows: Optional[np.ndarray] = None,
                   may: Optional[np.ndarray] = None):
        """One batched write op; ``rows``/``may`` as for ``_read_all``."""
        region, p_lo, p_hi = self._page_range_all(ga, lo, hi, prefetch=False)
        d = self.dirs[region]
        rows = self._rows_all if rows is None else rows
        if may is not None:
            rows = self._op_danger_split(d, ga, lo, hi, p_lo, p_hi, rows,
                                         may, is_write=True)
        if rows.size:
            d.ensure_rows(p_lo[rows], p_hi[rows], rows)
            d.note_dirty(rows, p_lo[rows], p_hi[rows])
            L = (p_hi - p_lo)[rows]
            if use_dense(rows.size, int(L.max())):
                self._write_dense(d, region, lo, hi, p_lo, p_hi, rows)
            else:
                c0 = p_lo[rows] - d.base[rows]
                uk, inv = np.unique(np.stack([c0, L], axis=1), axis=0,
                                    return_inverse=True)
                inv = inv.reshape(-1)
                for g in range(uk.shape[0]):
                    self._write_uniform(d, region, lo, hi, p_lo, p_hi,
                                        rows[inv == g],
                                        int(uk[g, 0]), int(uk[g, 1]))
            d.maybe_dirty = True
            for w in rows:
                self._dirty_regions[w].add(region)
        if may is not None:
            self._evict_rows_batch(rows)

    def _write_edges(self, region: int, first: np.ndarray, last: np.ndarray,
                     p_lo: np.ndarray, p_hi: np.ndarray, rows: np.ndarray):
        """Write-allocate edge fetches (first page, then last page — the
        per-worker path's order), only for the workers that need them."""
        if first.any():
            r = rows[np.nonzero(first)[0]]
            self._fetch_range_all(region, p_lo[r], p_lo[r] + 1, r)
        if last.any():
            r = rows[np.nonzero(last)[0]]
            self._fetch_range_all(region, p_hi[r] - 1, p_hi[r], r)

    def _write_dense(self, d: RegionDirectory, region: int,
                     lo: np.ndarray, hi: np.ndarray, p_lo: np.ndarray,
                     p_hi: np.ndarray, rows: np.ndarray):
        pw = self.page_words
        n_words = (hi - lo)[rows]

        # mechanism cost, in the per-worker path's charge order
        if self.model_mechanism and self.protocol == FINE_PROTO:
            self.clock[rows] += n_words * self.instr_s_per_word
        cols, mask = d.range_cols(p_lo[rows], p_hi[rows], rows)
        r2 = d.ix(rows)[:, None]
        c2 = d.ix(np.where(mask, cols, 0))
        ri, ci = np.nonzero(mask)
        cells = (d.ix(rows[ri]), d.ix(cols[ri, ci]))
        if self._track_wprot:
            wsub = d.wprot[r2, c2].cpu().numpy() & mask
            self.clock[rows] += wsub.sum(axis=1) * self.fault_s
            d.wprot[cells] = False

        n_pg = (p_hi - p_lo)[rows]
        if self.protocol != IDEAL_PROTO:
            single = n_pg == 1
            first = np.where(single, n_words < pw, lo[rows] % pw != 0)
            last = (~single) & (hi[rows] % pw != 0)
            self._write_edges(region, first, last, p_lo, p_hi, rows)
        if d.touch is not None:
            self._touch_cells(d, region, rows, cols, mask, n_pg)
        d.valid[cells] = True
        d.dirty[cells] = True

    def _write_uniform(self, d: RegionDirectory, region: int,
                       lo: np.ndarray, hi: np.ndarray, p_lo: np.ndarray,
                       p_hi: np.ndarray, rows: np.ndarray, c0: int, n: int):
        """One uniform-span write group: all ``rows`` write columns
        [c0, c0+n) of their windows — 2D slice ops, charges term for term
        those of the per-worker ``write``."""
        pw = self.page_words
        s = slice(c0, c0 + n)
        rb = d.row_block(rows)
        n_words = (hi - lo)[rows]
        if self.model_mechanism and self.protocol == FINE_PROTO:
            self.clock[rows] += n_words * self.instr_s_per_word
        if self._track_wprot:
            n_faults = d.wprot[rb, s].sum(dim=1).cpu().numpy()
            self.clock[rows] += n_faults * self.fault_s
            d.wprot[rb, s] = False
        if self.protocol != IDEAL_PROTO:
            if n == 1:
                first = n_words < pw
                last = np.zeros(rows.size, bool)
            else:
                first = lo[rows] % pw != 0
                last = hi[rows] % pw != 0
            self._write_edges(region, first, last, p_lo, p_hi, rows)
        if d.touch is not None:
            self._touch_block(d, region, rows, rb, s, c0, n)
        d.valid[rb, s] = True
        d.dirty[rb, s] = True

    def phase_all(self, reads=(), writes=(), *, flops=0.0, mem_bytes=0.0,
                  seconds=0.0, instr_words=0.0):
        """One SPMD phase for ALL workers in a single runtime call.

        ``reads``/``writes`` are sequences of ``(ga, lo, hi)`` with
        ``lo``/``hi`` as (W,) int arrays (scalars broadcast);
        ``flops``/``mem_bytes``/``seconds``/``instr_words`` may be scalars
        or (W,) arrays.  Bit-exactly equivalent to
        ``for w in range(W): phase(w, ...)``.  Within a phase workers
        interact only through eviction writebacks, so:

        * when no worker can cross the eviction watermark
          (``_may_evict_mask``), ops run op-major as single vectorized
          passes over the (W, window) planes;
        * otherwise the workers that ``_residual_workers`` proves
          independent run batched too, with per-op watermark eviction
          (``_evict_rows_batch``) and the per-op danger screen;
        * only the residual interacting workers replay through the
          per-worker ``phase``, in worker order.

        Must be called outside spans."""
        if any(self.spans):
            raise RuntimeError("phase_all must run outside spans")
        self.chaos_tick()
        W = self.W
        reads = [(ga, self._w_arr(lo), self._w_arr(hi))
                 for ga, lo, hi in reads]
        writes = [(ga, self._w_arr(lo), self._w_arr(hi))
                  for ga, lo, hi in writes]
        rranges = [self._page_range_all(ga, lo, hi, prefetch=True)
                   for ga, lo, hi in reads]
        wranges = [self._page_range_all(ga, lo, hi, prefetch=False)
                   for ga, lo, hi in writes]
        may = self._may_evict_mask(rranges + wranges)
        resid = None
        if may is not None and self.protocol != IDEAL_PROTO:
            r = self._residual_workers(rranges, wranges, may)
            if r.any():
                resid = r
        rows = None if resid is None else np.nonzero(~resid)[0]
        self.stats["batched_phases"] += 1
        self._race_suspend = True
        if rows is None or rows.size:
            for ga, lo, hi in reads:
                self._read_all(ga, lo, hi, rows=rows, may=may)
            for ga, lo, hi in writes:
                self._write_all(ga, lo, hi, rows=rows, may=may)
        fl = np.asarray(flops, np.float64)
        mb = np.asarray(mem_bytes, np.float64)
        sec = np.asarray(seconds, np.float64)
        iw = np.asarray(instr_words, np.float64)
        crows = self._rows_all if rows is None else rows
        if crows.size:
            if fl.any() or mb.any() or sec.any():
                sharing = self.cost.workers_on_node(W)
                bw = self.cost.node_bw(sharing) / max(1, sharing)
                t = np.broadcast_to(
                    sec + np.maximum(fl / self.cost.flops_per_worker,
                                     mb / bw), (W,))
                self.clock[crows] += t[crows]
            if (self.model_mechanism and self.protocol == FINE_PROTO
                    and iw.any()):
                self.clock[crows] += np.broadcast_to(
                    iw * self.instr_s_per_word, (W,))[crows]
        if resid is not None:
            # tick-ordered replay of the interacting workers, in worker
            # order (the loop driver's order within each dependence class)
            self.stats["residual_replays"] += int(resid.sum())
            flb, mbb, secb, iwb = (np.broadcast_to(v, (W,))
                                   for v in (fl, mb, sec, iw))
            for w in np.nonzero(resid)[0]:
                self.phase(
                    int(w),
                    reads=[(ga, int(lo[w]), int(hi[w]))
                           for ga, lo, hi in reads],
                    writes=[(ga, int(lo[w]), int(hi[w]))
                            for ga, lo, hi in writes],
                    flops=float(flb[w]), mem_bytes=float(mbb[w]),
                    seconds=float(secb[w]), instr_words=float(iwb[w]))
        self._race_suspend = False
        if self.detect_races:
            self._race_phase_all(reads, writes)

    # ------------------------------------------------------------------
    # worker-axis batched span driver (span_all)
    # ------------------------------------------------------------------

    def _span_one(self, w: int, lock_id: int, reads, writes):
        """One worker's whole consistency region through the per-worker
        path: the serial body every batched ``span_all`` path is held
        bit-equal against, and what runs where batching is not exact."""
        self.acquire(w, lock_id)
        for ga, lo, hi in reads:
            self.read(w, ga, int(lo[w]), int(hi[w]))
        for ga, lo, hi in writes:
            self.write(w, ga, int(lo[w]), int(hi[w]))
        self.release(w, lock_id)

    def _span_flush_safe(self, rows: np.ndarray, locks: np.ndarray,
                         ranges) -> bool:
        """May every masked worker's acquire-time ordinary flush hoist to
        one batched pass before any span body runs?  Exact iff no flushed
        dirty page (or its sharer invalidation) can be observed by a span
        body or a notice replay of this pass: the masked workers' dirty
        bounds must miss every declared (prefetch-extended) read/write
        page range and the pending-notice page bounds of every lock
        involved.  All intervals are absolute pages (host state only)."""
        spans_iv = []
        for region, p_lo, p_hi in ranges:
            spans_iv.append((int(p_lo[rows].min()), int(p_hi[rows].max())))
        for lk_id in np.unique(locks[rows]):
            lk = self.locks.get(int(lk_id))
            if lk is None:
                continue
            grp = rows[locks[rows] == lk_id]
            v_min = int(lk.seen[grp].min())
            if v_min >= lk.version:
                continue
            pb_iv = lk.log.page_bounds(v_min, lk.version)
            if pb_iv is not None:
                spans_iv.append(pb_iv)
        if not spans_iv:
            return True
        for d in self.dirs:
            dlo, dhi = d.dirty_lo[rows], d.dirty_hi[rows]
            m = dlo < dhi
            if not m.any():
                continue
            lo, hi = int(dlo[m].min()), int(dhi[m].max())
            for rlo, rhi in spans_iv:
                if rlo < hi and rhi > lo:
                    return False
        return True

    def _span_group_vec(self, grp: np.ndarray, lock_id: int, reads, writes,
                        rranges, wranges) -> bool:
        """Analytic batched pass of one uniform same-lock span group, the
        fast path of ``span_all``, as the reference computes it.

        Grants stay serialized (the host's release-time chain below), but
        the work around them runs across the group as (G, P) plane ops on
        the device: the i-th holder's pending notices are exactly the
        earlier holders' releases of this pass (every member has replayed
        the lock's log, or its backlog repeats this pass's payload), and
        every member publishes the same declared write intervals, so
        replay invalidations, fetch misses, write faults and the release
        payload resolve as matrix ops, one batched log append and a
        G-step clock chain that repeats the per-worker charges term for
        term (bit-equal clocks).  Regions resolve one by one (a page lies
        in one region; the payload concatenates in region order, which is
        page order).

        On the device: per region one upload of the (G, P) flat cell
        index, one gather a plane (``valid``, and ``incache`` and
        ``wprot`` where tracked) and one scatter back; the op effects in
        between.  The host reads back, in one int64 copy, each read op's
        miss counts, each write op's fault counts and edge misses, the
        replay hits and the cache entries.

        Returns False (the caller runs the serial body) for a non-uniform
        group, an empty interval or a backlog that is not this payload
        (``span_backlog_serial`` counts the latter).  In-span eviction
        never reaches here: ``span_all`` serializes it."""
        lk = self.locks.setdefault(lock_id, _Lock(self.W))
        w0 = int(grp[0])
        ops = []      # (ga, lo, hi, p_lo, p_hi, is_write, region), uniform
        regions = []
        for (ga, lo, hi), (region, p_lo, p_hi), is_w in (
                [(o, r, False) for o, r in zip(reads, rranges)]
                + [(o, r, True) for o, r in zip(writes, wranges)]):
            if (not (lo[grp] == lo[w0]).all()
                    or not (hi[grp] == hi[w0]).all()):
                return False
            if int(hi[w0]) <= int(lo[w0]):
                return False
            if region not in regions:
                regions.append(region)
            ops.append((ga, int(lo[w0]), int(hi[w0]),
                        int(p_lo[w0]), int(p_hi[w0]), is_w, region))
        regions.sort()

        G = int(grp.size)
        IDEAL = self.protocol == IDEAL_PROTO
        FINE = self.protocol == FINE_PROTO
        pw = self.page_words
        pb = self.page_bytes
        track = self.cache_pages is not None
        imax = np.iinfo(np.int64).max
        imin = np.iinfo(np.int64).min

        # per region: the union window [u_lo, u_lo + P) of the group's ops,
        # its rows' flat cell indices, and the payload accumulator (per
        # declared-write page, the coalesced word interval every member
        # publishes and every later holder replays)
        ctx = {}
        for r in regions:
            d = self.dirs[r]
            u_lo = min(op[3] for op in ops if op[6] == r)
            u_hi = max(op[4] for op in ops if op[6] == r)
            P = u_hi - u_lo
            d.ensure_rows(np.full(G, u_lo, np.int64),
                          np.full(G, u_hi, np.int64), grp)
            ctx[r] = {"d": d, "u_lo": u_lo, "P": P,
                      "lin": ((grp * d.cap + u_lo - d.base[grp])[:, None]
                              + np.arange(P)[None, :]),
                      "pend": np.zeros(P, bool),
                      "wlo": np.full(P, imax, np.int64),
                      "whi": np.full(P, imin, np.int64),
                      "ticks": [], "last": np.full(P, -1, np.int64),
                      "enters": None}
        for ga, lo, hi, p_lo, p_hi, is_w, r in ops:
            if not is_w:
                continue
            c = ctx[r]
            sl = slice(p_lo - c["u_lo"], p_hi - c["u_lo"])
            bw_ = (np.arange(p_lo, p_hi) - ga.page_lo) * pw
            c["pend"][sl] = True
            np.minimum(c["wlo"][sl], np.maximum(lo - bw_, 0),
                       out=c["wlo"][sl])
            np.maximum(c["whi"][sl], np.minimum(hi - bw_, pw),
                       out=c["whi"][sl])
        if regions:
            parts = []
            for r in regions:
                c = ctx[r]
                rel_idx = np.nonzero(c["pend"])[0]
                parts.append((rel_idx + c["u_lo"], c["wlo"][rel_idx],
                              c["whi"][rel_idx]))
            rel_pages = np.concatenate([p[0] for p in parts])
            rel_los = np.concatenate([p[1] for p in parts])
            rel_his = np.concatenate([p[2] for p in parts])
        else:
            rel_pages = rel_los = rel_his = np.zeros(0, np.int64)
        npend = int(rel_pages.size)
        pub_bytes = 0
        if npend:
            if FINE:
                pub_bytes = (int((rel_his - rel_los).sum()) * _WORD
                             + npend * (pw // 8))
            else:
                pub_bytes = npend * pb

        # pending sets: member i replays the earlier i releases of THIS
        # pass, plus a backlog only where the backlog repeats this payload
        v0 = lk.version
        seen = lk.seen[grp]
        has_pend = np.ones(G, bool)
        has_pend[0] = int(seen[0]) < v0
        v_min = int(seen.min())
        if v_min < v0:
            sizes = np.diff(np.asarray(lk.log.voff[v_min:v0 + 1], np.int64))
            if npend == 0 or not (sizes == npend).all():
                # a backlog of another shape: pending sets diverge
                self.stats["span_backlog_serial"] += 1
                return False
            if not lk.log.payload_matches(v_min, v0, rel_pages, rel_los,
                                          rel_his):
                # the right shape but other pages
                self.stats["span_backlog_serial"] += 1
                return False

        # the group's (G, P) plane matrices, gathered after every window
        # grew (growth reallocates the planes)
        for r in regions:
            c = ctx[r]
            d = c["d"]
            lin = c["lin_t"] = d.ix(c["lin"])
            c["V"] = d.valid.view(-1)[lin]
            c["IC"] = d.incache.view(-1)[lin] if track else None
            c["WP"] = (d.wprot.view(-1)[lin] if self._track_wprot
                       else None)
        # the device counts the host reads back, as int64 pieces of one
        # flat copy: each piece's offset is kept on the host
        back = []
        size = [0]

        def put(t, k=G):
            back.append(t)
            size[0] += k
            return size[0] - k

        # replay effects (page protocol): the holders with a pending set
        # lose their valid copies of the payload's pages
        h0 = 0 if has_pend[0] else 1
        replay = npend and not IDEAL and not FINE
        hit_at = []
        if replay:
            for r in regions:
                c = ctx[r]
                if not c["pend"].any():
                    continue
                V = c["V"][h0:]
                pend = torch.as_tensor(c["pend"], device=c["d"].device)
                hits = V & pend
                hit_at.append(put(hits.sum().reshape(1), 1))
                if c["WP"] is not None and self.model_mechanism:
                    c["WP"][h0:] |= hits
                V &= ~pend

        # op effects, op-major (the rows are mutually independent)
        layout = []        # per op: offsets of (misses | faults, first, last)
        for ga, lo, hi, p_lo, p_hi, is_w, r in ops:
            cx = ctx[r]
            V, WP = cx["V"], cx["WP"]
            sl = slice(p_lo - cx["u_lo"], p_hi - cx["u_lo"])
            n = p_hi - p_lo
            if not is_w:
                layout.append((None if IDEAL else
                               put((~V[:, sl]).sum(dim=1)), None, None))
                V[:, sl] = True
                if track:
                    self._span_track_touch(cx, grp, r, p_lo, n, sl)
                continue
            faults = None
            if WP is not None:
                faults = put(WP[:, sl].sum(dim=1))
                WP[:, sl] = False
            edges = [None, None]
            if not IDEAL:
                if n == 1:
                    parts = (hi - lo < pw, False)
                else:
                    parts = (lo % pw != 0, hi % pw != 0)
                for e, (part, p) in enumerate(zip(parts, (p_lo, p_hi - 1))):
                    if not part:
                        continue
                    c0 = p - cx["u_lo"]
                    edges[e] = put((~V[:, c0]).to(torch.int64))
                    V[:, c0] = True
                    if track:
                        self._span_track_touch(cx, grp, r, p, 1,
                                               slice(c0, c0 + 1))
            layout.append((faults, *edges))
            if track:
                self._span_track_touch(cx, grp, r, p_lo, n, sl)
            V[:, sl] = True

        # commit the planes; under a cache each touched cell takes the
        # tick of the last touch run that covered it (one upload, one
        # scatter), and the cells that entered the cache join the copy
        enters = []
        for r in regions:
            cx = ctx[r]
            d, lin = cx["d"], cx["lin_t"]
            d.valid.view(-1)[lin] = cx["V"]
            if track:
                d.incache.view(-1)[lin] = cx["IC"]
                cols = np.nonzero(cx["last"] >= 0)[0]
                tk = np.stack(cx["ticks"], axis=1)[:, cx["last"][cols]]
                it = torch.as_tensor(np.stack([cx["lin"][:, cols], tk]),
                                     device=d.device)
                d.touch.view(-1)[it[0]] = it[1]
                enters.append(cx["enters"])
            if cx["WP"] is not None:
                d.wprot.view(-1)[lin] = cx["WP"]
        enter_at = put(torch.stack(enters).sum(dim=0)) if enters else None
        got = (torch.cat([t.reshape(-1) for t in back]).cpu().numpy()
               if back else None)

        def at(o):
            return None if o is None else got[o:o + G]

        # host bookkeeping of what came back, in integer arithmetic
        if replay:
            n_inv = int(sum(got[o] for o in hit_at))
            self.traffic.invalidations += n_inv
            self._chaos_invals(n_inv)
            self.traffic.control_msgs += npend * int(has_pend.sum())
        zeros = np.zeros(G, np.int64)
        op_miss, op_faults, op_edges = [], [], []
        for op, (a, f, l) in zip(ops, layout):
            if not op[5]:
                op_miss.append(zeros if a is None else at(a))
                fetched = [at(a)]
            else:
                op_faults.append(at(a))
                op_edges.append((at(f), at(l)))
                fetched = [at(f), at(l)]
            for t in fetched:
                tot = 0 if t is None else int(t.sum())
                if tot:
                    self.traffic.page_fetches += tot
                    self.traffic.fetch_bytes += tot * pb
        if enter_at is not None:
            self.resident[grp] += at(enter_at)

        # publish: one batched log append, G versions
        if not IDEAL:
            if FINE and npend:
                self.traffic.diff_bytes += (pub_bytes            # replays
                                            * int(has_pend.sum()))
            if npend:
                if FINE:
                    self.traffic.diff_bytes += pub_bytes * G    # releases
                else:
                    self.traffic.writeback_bytes += pub_bytes * G
            lk.log.append_versions(
                np.tile(rel_pages, G), np.tile(rel_los, G),
                np.tile(rel_his, G), np.full(G, npend, np.int64))
            lk.version = v0 + G
            lk.seen[grp] = v0 + np.arange(1, G + 1)
        self.traffic.control_msgs += 3 * G          # acquire 2 + release 1

        # the grant chain, the only serialized part: each member's charges
        # are the per-worker path's, the same scalar expressions in the
        # same order, so clocks stay bit-equal to the span loop
        xfer = self.cost.xfer_s
        lat = self.cost.net_latency_s
        bw = self.cost.net_bw_Bps
        fb = self.fetch_batch
        ctrl2 = xfer(64, 2)
        ctrl1 = xfer(64, 1)
        # chaos: each message group's retry charge follows its base charge
        # as a separate term, in the per-worker path's order
        retry = (self.chaos.retry1 if self.chaos is not None
                 else lambda w: 0.0)
        t_rel = lk.last_release_time
        for i in range(G):
            w = int(grp[i])
            c = float(self.clock[w])
            if not IDEAL:
                c += ctrl2
                c += retry(w)
            c = max(c, t_rel)
            if has_pend[i] and npend and not IDEAL and FINE:
                c += lat * npend + pub_bytes / bw
                c += retry(w)
            ri = wi = 0
            for ga, lo, hi, p_lo, p_hi, is_w, _r in ops:
                if not is_w:
                    m = int(op_miss[ri][i])
                    ri += 1
                    if m and not IDEAL:
                        c += xfer(m * pb, 2 * -(-m // fb))
                        c += retry(w)
                    continue
                if self.model_mechanism and FINE:
                    c += (hi - lo) * self.instr_s_per_word
                if op_faults[wi] is not None:
                    c += int(op_faults[wi][i]) * self.fault_s
                first, last = op_edges[wi]
                wi += 1
                if first is not None and first[i]:
                    c += xfer(pb, 2)
                    c += retry(w)
                if last is not None and last[i]:
                    c += xfer(pb, 2)
                    c += retry(w)
            if not IDEAL and npend:
                c += lat * npend + pub_bytes / bw
                c += retry(w)
            if not IDEAL:
                c += ctrl1
                c += retry(w)
            self.clock[w] = c
            t_rel = c
        lk.last_release_time = t_rel
        self.stats["span_groups_vec"] += 1
        self.stats["span_workers_vec"] += G
        if len(regions) > 1:
            self.stats["span_multi_region_groups"] += 1
        return True

    def _span_track_touch(self, cx: dict, grp: np.ndarray, region: int,
                          p_lo: int, n: int, sl: slice):
        """LRU bookkeeping of one group op's touch run (cache runs only):
        one run a member on the host queues, in the per-worker path's
        order, its ticks kept for the commit's one touch scatter; the
        cells entering the cache are counted off the group's occupancy
        matrix on the device.  ``sl`` addresses [p_lo, p_lo + n) in the
        region's union-window columns.  Nothing evicts here (``span_all``
        serializes any pass that could), so the watermark never trips."""
        d = cx["d"]
        ticks = np.empty(grp.size, np.int64)
        for i, w in enumerate(grp):
            ticks[i] = self._q_append(int(w), region,
                                      int(p_lo - d.base[w]), n,
                                      int(d.shift[w]))
        cx["last"][sl] = len(cx["ticks"])
        cx["ticks"].append(ticks)
        IC = cx["IC"]
        enters = (~IC[:, sl]).sum(dim=1)
        cx["enters"] = enters if cx["enters"] is None else (cx["enters"]
                                                            + enters)
        IC[:, sl] = True

    def span_all(self, w_mask=None, lock_ids=0, reads=(), writes=()):
        """One consistency-region pass for many workers in one call.

        Equivalent (traffic field for field, clocks bit-equal, stats
        equal) to the per-worker span loop::

            for w in <masked workers, ascending>:
                with rt.span(w, lock_ids[w]):
                    for ga, lo, hi in reads:  rt.read(w, ga, lo[w], hi[w])
                    for ga, lo, hi in writes: rt.write(w, ga, lo[w], hi[w])

        ``w_mask`` is a (W,) bool mask or an array of worker indices
        (None: every worker); ``lock_ids`` a scalar or (W,);
        ``reads``/``writes`` as in ``phase_all``.

        Lock grants are the only true serialization point and stay
        serialized (the release-time chain); the work around them runs
        batched:

        * every masked worker's acquire-time ordinary flush hoists into
          one masked barrier-style flush (``_flush_all_workers(mask)``:
          one ``phase_step`` launch with its row mask on 'fused') when
          the flushed pages cannot meet any span page or pending notice
          (``_span_flush_safe``);
        * workers sharing a lock form a grant group; a uniform group
          resolves analytically as plane ops (``_span_group_vec``);
        * distinct locks' groups are independent (a span body touches
          only its own rows once eviction is excluded), so they run one
          after another.

        The reference's exactness screens decide what runs serially, and
        ``stats`` counts each: a non-uniform group runs the per-worker
        body (``span_serial_workers``); a pass that could evict inside a
        span under ``cache_pages``, or whose flush cannot hoist, runs the
        whole worker-order loop (``span_serial_calls``).  Under
        ``detect_races`` one end-of-call pass (``_race_span_all``) checks
        and records every member's accesses.  Under ``chaos`` the grant
        chain carries each member's retry terms in the per-worker path's
        order, on the same vectorized path."""
        if any(self.spans):
            raise RuntimeError("span_all must run outside spans")
        self.chaos_tick()
        W = self.W
        if w_mask is None:
            rows = self._rows_all
        else:
            w_mask = np.asarray(w_mask)
            rows = (np.nonzero(w_mask)[0] if w_mask.dtype == bool
                    else np.unique(np.asarray(w_mask, np.int64)))
        locks = self._w_arr(lock_ids)
        reads = [(ga, self._w_arr(lo), self._w_arr(hi))
                 for ga, lo, hi in reads]
        writes = [(ga, self._w_arr(lo), self._w_arr(hi))
                  for ga, lo, hi in writes]
        self.stats["span_all_calls"] += 1
        if rows.size == 0:
            return
        rranges = [self._page_range_all(ga, lo, hi, prefetch=True)
                   for ga, lo, hi in reads]
        wranges = [self._page_range_all(ga, lo, hi, prefetch=False)
                   for ga, lo, hi in writes]
        serial = False
        if self.cache_pages is not None:
            # any possible in-span eviction serializes the whole pass: an
            # eviction can write back into another worker's reach, and
            # the LRU queue walk is tick-ordered
            ub = self.resident.copy()
            for region, p_lo, p_hi in rranges + wranges:
                ub += p_hi - p_lo
            serial = bool((ub[rows] > self.cache_pages).any())
        if not serial and self.protocol != IDEAL_PROTO:
            serial = not self._span_flush_safe(rows, locks,
                                               rranges + wranges)
        self._race_suspend = True
        if serial:
            self.stats["span_serial_calls"] += 1
            self.stats["span_serial_workers"] += int(rows.size)
            for w in rows:
                self._span_one(int(w), int(locks[w]), reads, writes)
        else:
            mask = np.zeros(W, bool)
            mask[rows] = True
            self._flush_all_workers(mask)
            for lk_id in np.unique(locks[rows]):
                grp = rows[locks[rows] == int(lk_id)]
                if not self._span_group_vec(grp, int(lk_id), reads, writes,
                                            rranges, wranges):
                    self.stats["span_serial_workers"] += int(grp.size)
                    for w in grp:
                        self._span_one(int(w), int(lk_id), reads, writes)
        self._race_suspend = False
        if self.detect_races:
            self._race_span_all(rows, locks, reads, writes)

    # ------------------------------------------------------------------
    def reduce(self, w: int, name: str, value: float, op: str = "sum"):
        self._reductions.setdefault(name, []).append((float(value), op))

    def reduce_all(self, name: str, values, op: str = "sum"):
        """Batched ``reduce``: one contribution per worker in one call
        (``values`` scalar or (W,)); combines identically at the barrier."""
        vals = np.broadcast_to(np.asarray(values, np.float64), (self.W,))
        self._reductions.setdefault(name, []).extend(
            (float(v), op) for v in vals)

    def reduction_result(self, name: str) -> float:
        return self._reduction_results[name]

    def barrier(self):
        self.chaos_tick()
        self._flush_all_workers()
        if self.protocol != IDEAL_PROTO:
            for lk in self.locks.values():
                if (lk.seen == lk.version).all():
                    continue       # everyone current
                self._replay_stale(lk)
        if self.straggler is not None:
            flagged = self.straggler.observe(self.clock - self._bar_clock0)
            self.stats["straggler_checks"] += 1
            self.stats["straggler_flags"] += len(flagged)
        log_w = max(1, int(np.ceil(np.log2(max(self.W, 2)))))
        for name, contribs in self._reductions.items():
            vals = [v for v, _ in contribs]
            op = contribs[0][1]
            fn = {"sum": np.sum, "max": np.max, "min": np.min}[op]
            self._reduction_results[name] = float(fn(vals))
            self.traffic.reduction_msgs += self.W - 1
        self._reductions.clear()
        if self.detect_races:
            # the barrier orders everyone against everyone: join all
            # views, then every worker opens a new epoch
            self.race_vc[:] = self.race_vc.max(axis=0)[None, :]
            self.race_vc[self._rows_all, self._rows_all] += 1
        t = float(self.clock.max()) + self.cost.net_latency_s * log_w * (
            0 if self.protocol == IDEAL_PROTO else 1) + 1e-7 * log_w
        self.clock[:] = t
        self._bar_clock0 = self.clock.copy()

    def _replay_stale(self, lk: _Lock):
        """Barrier-time notice replay of every worker behind ``lk``'s log
        (after a grant group, all its members but the last): each worker's
        coalesced pending pages, then per region one gather of the
        pending cells of every such worker's row.  'fine' charges the
        diff bytes of the stale copies still valid; 'page' invalidates
        them (no wprot re-arm), one scatter.  A worker's replay touches
        only its own row, so the per-worker loop's traffic and planes
        come out of one batch."""
        rows = np.nonzero(lk.seen != lk.version)[0]
        parts = [(w, *lk.log.pending(int(lk.seen[w]), lk.version))
                 for w in rows.tolist()]
        lk.seen[rows] = lk.version
        parts = [p for p in parts if p[1].size]
        if not parts:
            return
        prow = np.concatenate([np.full(u.size, w, np.int64)
                               for w, u, _, _ in parts])
        pages = np.concatenate([u for _, u, _, _ in parts])
        nbytes = np.concatenate([(hi - lo) * _WORD for _, _, lo, hi in parts])
        regions = np.searchsorted(self._region_starts_np, pages, "right") - 1
        for r in np.unique(regions):
            d = self.dirs[int(r)]
            m = regions == r
            w_ = prow[m]
            cols = pages[m] - d.base[w_]
            inr = (d.base[w_] >= 0) & (cols >= 0) & (cols < d.length[w_])
            if not inr.any():
                continue
            cells = d.ix(np.stack([w_[inr], cols[inr]]))
            hit = d.valid[cells[0], cells[1]]
            if self.protocol == FINE_PROTO:
                self.traffic.diff_bytes += int(nbytes[m][inr][host(hit)].sum())
            else:
                n_inv = int(hit.sum())
                self.traffic.invalidations += n_inv
                self._chaos_invals(n_inv)
                d.valid[cells[0], cells[1]] = False

    @property
    def time(self) -> float:
        return float(self.clock.max())

    # ------------------------------------------------------------------
    # barrier-consistent checkpoints (ft/coherence.py)
    # ------------------------------------------------------------------

    def snapshot(self, rows: Optional[Tuple[int, int]] = None
                 ) -> Tuple[dict, dict]:
        """The complete runtime state as (arrays, meta), in the reference's
        ``snapshot()`` format: the same array names and dtypes, the same
        meta keys, the tier named in the reference's vocabulary
        (``_REF_BACKEND``) and the fused tier's launch count as
        ``jit_dispatches``, so the reference's ``from_snapshot`` restores
        it as it stands.

        Only legal at a consistent cut (no open span, no unresolved
        reduction, no danger recording): right after a ``barrier()`` or
        before any work.  There the directory planes (brought to the host
        once), lock logs, LRU queues, clocks, traffic, stats and the
        chaos/straggler counters are the entire protocol state, and
        :meth:`from_snapshot` rebuilds a runtime whose every later event
        is bit-identical to this one's.  ``arrays`` holds numpy arrays
        only; ``meta`` is JSON-serializable.

        ``rows=(w_lo, w_hi)`` restricts the worker-major payload to one
        shard's contiguous worker slice (directory plane rows, sliced on
        the device before the copy back, clocks, LRU queues, lock
        ``seen`` vectors, per-worker chaos/straggler counters); the
        worker-independent state (lock logs, reduction results, global
        counters) is carried whole by every slice, and
        :meth:`compose_snapshots` reassembles the slices, checking that
        the replicated globals agree bit for bit.  A slice records
        ``meta["slice"]`` and cannot be restored directly."""
        if any(self.spans):
            raise RuntimeError("snapshot inside an open span")
        if self._reductions:
            raise RuntimeError("snapshot with unresolved reductions")
        if self._danger_rec is not None:
            raise RuntimeError("snapshot during danger recording")
        arrays: Dict[str, np.ndarray] = {
            "clock": self.clock.copy(),
            "bar_clock0": self._bar_clock0.copy(),
            "resident": self.resident.copy(),
            "q_degraded": self._q_degraded.copy(),
        }
        # LRU touch-run queues: flat (N, 7) entry rows + per-worker counts
        arrays["lru_counts"] = np.array([len(q) for q in self._lru_q],
                                        np.int64)
        arrays["lru_entries"] = (
            np.array([list(e) for q in self._lru_q for e in q], np.int64)
            if int(arrays["lru_counts"].sum())
            else np.zeros((0, 7), np.int64))
        arrays["dirty_region_counts"] = np.array(
            [len(r) for r in self._dirty_regions], np.int64)
        arrays["dirty_region_flat"] = np.array(
            [x for r in self._dirty_regions for x in sorted(r)], np.int64)
        red_names = sorted(self._reduction_results)
        arrays["red_vals"] = np.array(
            [self._reduction_results[k] for k in red_names], np.float64)
        if rows is not None:
            w_lo, w_hi = int(rows[0]), int(rows[1])
            if not 0 <= w_lo < w_hi <= self.W:
                raise ValueError(f"snapshot rows {rows} outside [0, {self.W})")
        dir_rows = None if rows is None else slice(w_lo, w_hi)
        dir_arrays: Dict[str, np.ndarray] = {}
        dir_metas = []
        for r, d in enumerate(self.dirs):
            darr, dmeta = d.state_arrays(rows=dir_rows)
            for k, v in darr.items():
                dir_arrays[f"d{r:05d}_{k}"] = v
            dir_metas.append(dict(dmeta, backend=_REF_BACKEND[d.backend]))
        lock_metas = []
        for j, (lid, lk) in enumerate(sorted(self.locks.items())):
            pre = f"lk{j:05d}_"
            arrays[pre + "seen"] = lk.seen.copy()
            arrays[pre + "lrt"] = np.array([lk.last_release_time],
                                           np.float64)
            if self.detect_races:
                arrays[pre + "vc"] = lk.race_vc.copy()
            for k, v in lk.log.state_arrays().items():
                arrays[pre + k] = v
            lock_metas.append({"id": int(lid), "version": int(lk.version)})
        if self.detect_races:
            # race_set rows are (page, a, b, kind) with kind 0 for 'ww'
            arrays["race_vc"] = self.race_vc.copy()
            arrays["race_set"] = (np.array(
                sorted((p, a, b, 0 if kind == "ww" else 1)
                       for p, a, b, kind in self.races), np.int64)
                if self.races else np.zeros((0, 4), np.int64))
        if self.chaos is not None:
            arrays.update(self.chaos.state_arrays())
        if self.straggler is not None:
            for k, v in self.straggler.state_arrays().items():
                arrays["strag_" + k] = v
        stats = {k: v for k, v in self.stats.items()
                 if k != "fused_dispatches"}
        stats["jit_dispatches"] = self.stats["fused_dispatches"]
        stats["jit_cache_misses"] = 0
        meta = {
            "config": {"n_workers": self.W, "page_words": self.page_words,
                       "protocol": self.protocol,
                       "cache_pages": self.cache_pages,
                       "prefetch": self.prefetch,
                       # the reference's default; neither engine reads it
                       "n_mem_servers": 1,
                       "model_mechanism": self.model_mechanism,
                       "instr_s_per_word": self.instr_s_per_word,
                       "fault_s": self.fault_s,
                       "fetch_batch": self.fetch_batch,
                       "backend": _REF_BACKEND[self.backend],
                       "danger_mode": self.danger_mode,
                       "detect_races": self.detect_races},
            "cost": dataclasses.asdict(self.cost),
            "traffic": dataclasses.asdict(self.traffic),
            "stats": stats,
            "tick": self._tick,
            "phase_idx": self._phase_idx,
            "n_pages": self.n_pages,
            "region_starts": [int(x) for x in self._region_starts],
            "region_ends": [int(x) for x in self._region_ends],
            "dirs": dir_metas,
            "locks": lock_metas,
            "red_names": red_names,
            "chaos": None if self.chaos is None else self.chaos.config(),
            "straggler": (None if self.straggler is None
                          else self.straggler.config()),
        }
        if rows is not None:
            # the directory planes came back already sliced
            arrays = _slice_snapshot_arrays(arrays, w_lo, w_hi)
            meta["slice"] = [w_lo, w_hi]
        arrays.update(dir_arrays)
        return arrays, meta

    @classmethod
    def from_snapshot(cls, arrays: dict, meta: dict, *, injector=None,
                      backend: Optional[str] = None,
                      device=None) -> "RegCScaleRuntime":
        """Rebuild a runtime from ``snapshot()`` output of either package:
        the same clocks, traffic, stats, directory planes (uploaded to
        ``device``; the cached device tensors derived from them are built
        anew), lock logs, LRU order and chaos/straggler state, so every
        later event is bit-identical.  ``backend`` overrides the
        snapshot's tier (either vocabulary is read); pass a (possibly
        partly fired) ``injector`` to rearm failure injection on the
        replayed suffix.  Shard-slice snapshots raise."""
        from repro_torch.dsm.costmodel import ChaosNet
        from repro_torch.ft.runtime import StragglerMonitor
        if meta.get("slice") is not None:
            raise ValueError("from_snapshot: a partial (shard-slice) "
                             "snapshot; compose_snapshots first")
        cfg = meta["config"]
        if backend is None:
            backend = _OUR_BACKEND.get(cfg["backend"], cfg["backend"])
        chaos = (None if meta.get("chaos") is None
                 else ChaosNet(**meta["chaos"]))
        straggler = None
        if meta.get("straggler") is not None:
            straggler = StragglerMonitor.from_state(
                {k[len("strag_"):]: v for k, v in arrays.items()
                 if k.startswith("strag_")}, meta["straggler"])
        cache_pages = cfg["cache_pages"]
        rt = cls(int(cfg["n_workers"]), page_words=int(cfg["page_words"]),
                 protocol=cfg["protocol"], cost=CostModel(**meta["cost"]),
                 prefetch=int(cfg["prefetch"]),
                 model_mechanism=bool(cfg["model_mechanism"]),
                 instr_s_per_word=float(cfg["instr_s_per_word"]),
                 fault_s=float(cfg["fault_s"]),
                 fetch_batch=int(cfg["fetch_batch"]), backend=backend,
                 cache_pages=(None if cache_pages is None
                              else int(cache_pages)),
                 danger_mode=cfg.get("danger_mode", "vec"),
                 detect_races=bool(cfg.get("detect_races", False)),
                 chaos=chaos, injector=injector, straggler=straggler,
                 device=device)
        rt.n_pages = int(meta["n_pages"])
        rt._region_starts = [int(x) for x in meta["region_starts"]]
        rt._region_ends = [int(x) for x in meta["region_ends"]]
        rt._region_starts_np = np.asarray(rt._region_starts, np.int64)
        rt.dirs = []
        for r, dmeta in enumerate(meta["dirs"]):
            pre = f"d{r:05d}_"
            darr = {k[len(pre):]: v for k, v in arrays.items()
                    if k.startswith(pre)}
            d = RegionDirectory.from_state(darr, dmeta, backend=backend,
                                           device=rt.device)
            d.stats = rt.stats
            rt.dirs.append(d)
        rt.locks = {}
        for j, lm in enumerate(meta["locks"]):
            pre = f"lk{j:05d}_"
            lk = _Lock(rt.W)
            lk.version = int(lm["version"])
            lk.seen = np.asarray(arrays[pre + "seen"], np.int64).copy()
            lk.last_release_time = float(np.asarray(arrays[pre + "lrt"])[0])
            lk.log = IntervalLog.from_state(
                {k: arrays[pre + k] for k in ("p", "lo", "hi", "voff")})
            if pre + "vc" in arrays:
                lk.race_vc = np.asarray(arrays[pre + "vc"], np.int64).copy()
            rt.locks[int(lm["id"])] = lk
        if rt.detect_races:
            rt.race_vc = np.asarray(arrays["race_vc"], np.int64).copy()
            rs = np.asarray(arrays["race_set"], np.int64).reshape(-1, 4)
            rt.races = {(int(p), int(a), int(b), "ww" if k == 0 else "rw")
                        for p, a, b, k in rs}
        rt.clock = np.asarray(arrays["clock"], np.float64).copy()
        rt._bar_clock0 = np.asarray(arrays["bar_clock0"], np.float64).copy()
        rt.resident = np.asarray(arrays["resident"], np.int64).copy()
        rt._q_degraded = np.asarray(arrays["q_degraded"], bool).copy()
        ents = np.asarray(arrays["lru_entries"], np.int64).reshape(-1, 7)
        offs = np.concatenate([[0], np.cumsum(
            np.asarray(arrays["lru_counts"], np.int64))])
        rt._lru_q = [deque([int(x) for x in e]
                           for e in ents[offs[w]:offs[w + 1]])
                     for w in range(rt.W)]
        flat = np.asarray(arrays["dirty_region_flat"], np.int64)
        offs = np.concatenate([[0], np.cumsum(
            np.asarray(arrays["dirty_region_counts"], np.int64))])
        rt._dirty_regions = [set(int(x) for x in flat[offs[w]:offs[w + 1]])
                             for w in range(rt.W)]
        rt.traffic = Traffic(**meta["traffic"])
        # in place: a bound ChaosNet holds a reference to rt.stats; the
        # reference's jit_dispatches is this package's fused_dispatches
        stats = dict(meta["stats"])
        fused = stats.pop("jit_dispatches", 0)
        stats.pop("jit_cache_misses", None)
        stats.setdefault("fused_dispatches", fused)
        rt.stats.clear()
        rt.stats.update(stats)
        if chaos is not None:
            chaos.load_state(arrays)
        rt._tick = int(meta["tick"])
        rt._phase_idx = int(meta["phase_idx"])
        rt._reduction_results = {
            k: float(v) for k, v in zip(
                meta["red_names"], np.asarray(arrays["red_vals"], np.float64))}
        return rt

    @classmethod
    def compose_snapshots(cls, parts) -> Tuple[dict, dict]:
        """Reassemble shard-slice snapshots (``snapshot(rows=...)`` output
        of either package, in any order) into one full (arrays, meta)
        that :meth:`from_snapshot` restores.

        The slices must tile ``[0, W)`` exactly.  Worker-major arrays are
        concatenated in slice order; the replicated globals (lock logs,
        reduction results, global chaos/straggler counters, traffic,
        stats, configs) must agree bit for bit across every slice: a
        mismatch means the shard replicas diverged, which the cluster
        treats as a protocol error, not a fault to recover from.  Slices
        that do not tile, or that disagree, raise ``ValueError``."""
        parts = sorted(parts, key=lambda p: p[1]["slice"][0])
        if not parts:
            raise ValueError("compose_snapshots of nothing")
        metas = [m for _a, m in parts]
        W = int(metas[0]["config"]["n_workers"])
        want = 0
        for lo, hi in (tuple(m["slice"]) for m in metas):
            if lo != want:
                raise ValueError(f"slices do not tile: gap before {lo}")
            want = hi
        if want != W:
            raise ValueError(f"slices cover [0, {want}) of {W} workers")
        ref_meta = {k: v for k, v in metas[0].items() if k != "slice"}
        keys = set(parts[0][0])
        for a, m in parts[1:]:
            if {k: v for k, v in m.items() if k != "slice"} != ref_meta:
                raise ValueError("shard snapshot metas diverged")
            if set(a) != keys:
                raise ValueError("shard snapshot keys diverged")
        out: Dict[str, np.ndarray] = {}
        for k in keys:
            vals = [a[k] for a, _m in parts]
            if _snapshot_key_kind(k) != "global":
                out[k] = np.concatenate(vals, axis=0)
                continue
            for v in vals[1:]:
                if v.dtype != vals[0].dtype or not np.array_equal(v, vals[0]):
                    raise ValueError(f"replicated snapshot key {k!r} "
                                     "diverged across shards")
            out[k] = vals[0].copy()
        return out, ref_meta

    def gas_for_region(self, region: int, n_elems: int) -> GasArray:
        """Handle for an allocation that already exists in the directory
        (the restore-side replacement for ``alloc``: snapshots persist
        regions, not the caller's handles)."""
        return GasArray(self._region_starts[region], n_elems,
                        self.page_words)


# ---------------------------------------------------------------------------
# shard-slice snapshot plumbing (repro_torch.cluster).  Snapshot keys fall
# into three kinds:
#   rows   - worker-major, first dim W: sliced per shard, concatenated
#            back in slice order by compose_snapshots
#   flat   - variable-length per-worker payloads stored as (flat, counts)
#            pairs: sliced by the counts' prefix sums, concatenated back
#   global - worker-independent replicated state (lock logs, reduction
#            results, global chaos/straggler totals): carried whole by
#            every slice, checked bit-equal on compose
# ---------------------------------------------------------------------------

_SNAP_ROW_KEYS = frozenset({
    "clock", "bar_clock0", "resident", "q_degraded",
    "lru_counts", "dirty_region_counts", "race_vc",
    "chaos_msg_seq", "strag_hist_counts", "strag_streak"})
_SNAP_FLAT_COUNTS = {"lru_entries": "lru_counts",
                     "dirty_region_flat": "dirty_region_counts",
                     "strag_hist": "strag_hist_counts"}
_SNAP_DIR_RE = re.compile(r"^d\d{5}_")       # directory planes: all (W, ...)
# per-worker lock state: version seen + (detect_races) lock vector clock
_SNAP_SEEN_RE = re.compile(r"^lk\d{5}_(seen|vc)$")


def _snapshot_key_kind(key: str) -> str:
    if key in _SNAP_ROW_KEYS or _SNAP_DIR_RE.match(key) \
            or _SNAP_SEEN_RE.match(key):
        return "rows"
    if key in _SNAP_FLAT_COUNTS:
        return "flat"
    return "global"


def _slice_snapshot_arrays(arrays: Dict[str, np.ndarray], w_lo: int,
                           w_hi: int) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in arrays.items():
        kind = _snapshot_key_kind(k)
        if kind == "rows":
            out[k] = v[w_lo:w_hi].copy()
        elif kind == "flat":
            counts = np.asarray(arrays[_SNAP_FLAT_COUNTS[k]], np.int64)
            off = np.concatenate([[0], np.cumsum(counts)])
            out[k] = v[int(off[w_lo]):int(off[w_hi])].copy()
        else:
            out[k] = v.copy()
    return out
