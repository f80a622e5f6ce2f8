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

This is slice A of the port: the main path without spill.  Eviction
under ``cache_pages`` (slice B), the batched ``span_all`` driver (slice
C), race detection (slice D) and the fault-injection hooks are not here
yet; ``config.RuntimeConfig`` refuses the knobs that would reach them.

Store-tracking mechanisms (paper §IV), modeled as in the reference:

* ``fine``  (samhita): every store is instrumented with a runtime call ->
  ``instr_s_per_word`` per stored word, ordinary AND consistency regions;
* ``page``  (samhita_page): write detection via VM protection -> one
  ``fault_s`` per (page x write-epoch), re-armed when the page is flushed.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import (BACKENDS, FAULT_S, FINE_PROTO,
                                     IDEAL_PROTO, INSTR_S_PER_WORD,
                                     PAGE_PROTO, PROTOCOLS, check_choice,
                                     resolve_device)
from repro_torch.core.directory import IntervalLog, RegionDirectory, use_dense
from repro_torch.core.regc import _WORD, GasArray, Traffic
from repro_torch.dsm.costmodel import IB_2013, CostModel
from repro_torch.kernels import protocol_sweep as _ps

# the reference's stats keys (its jit_* accounting aside), so stats of the
# two engines compare key for key; the keys of paths that belong to later
# slices stay 0 here
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
    __slots__ = ("version", "log", "last_release_time", "seen")

    def __init__(self, n_workers):
        self.version = 0
        self.log = IntervalLog()
        self.last_release_time = 0.0
        self.seen = np.zeros(n_workers, np.int64)


class RegCScaleRuntime:
    """Metadata-only, directory-vectorized RegC engine on a torch device."""

    def __init__(self, n_workers: int, *, page_words: int = 1024,
                 protocol: str = FINE_PROTO, cost: CostModel = IB_2013,
                 prefetch: int = 1,
                 model_mechanism: bool = True,
                 instr_s_per_word: float = INSTR_S_PER_WORD,
                 fault_s: float = FAULT_S, fetch_batch: int = 1,
                 backend: str = "fused", device=None):
        check_choice("protocol", protocol, PROTOCOLS)
        check_choice("backend", backend, BACKENDS)
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

        self.n_pages = 0
        self._region_starts: List[int] = []     # sorted page_lo per region
        self._region_ends: List[int] = []
        self._region_starts_np = np.zeros(0, np.int64)
        self.dirs: List[RegionDirectory] = []
        self.spans: List[List[_Span]] = [[] for _ in range(n_workers)]
        self.locks: Dict[int, _Lock] = {}
        self.clock = np.zeros(n_workers)
        self.traffic = Traffic()
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
        self._phase_idx = 0
        self._bar_clock0 = np.zeros(n_workers)

    # ------------------------------------------------------------------
    def alloc(self, n_elems: int) -> GasArray:
        pages = -(-n_elems // self.page_words)
        ga = GasArray(self.n_pages, n_elems, self.page_words)
        self._region_starts.append(self.n_pages)
        self._region_ends.append(self.n_pages + pages)
        self._region_starts_np = np.asarray(self._region_starts, np.int64)
        d = RegionDirectory(
            self.W, len(self.dirs), self.n_pages, self.n_pages + pages,
            track_wprot=self._track_wprot, backend=self.backend,
            device=self.device)
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
    # per-worker reads / writes (interval API)
    # ------------------------------------------------------------------

    def _fetch_range(self, w: int, region: int, p_lo: int, p_hi: int):
        """Make pages [p_lo, p_hi) valid at w, charging misses."""
        d = self.dirs[region]
        d.ensure(w, p_lo, p_hi)
        s = d.sl(w, p_lo, p_hi)
        n = p_hi - p_lo
        n_miss = n - int(d.valid[w, s].sum())
        if n_miss:
            if self.protocol != IDEAL_PROTO:
                self.traffic.page_fetches += n_miss
                self.traffic.fetch_bytes += n_miss * self.page_bytes
                n_req = -(-n_miss // self.fetch_batch)
                self._net(w, n_miss * self.page_bytes, 2 * n_req)
            d.valid[w, s] = True

    def read(self, w: int, ga: GasArray, lo: int, hi: int):
        region = self._region_of(ga.page_lo)
        p_lo = ga.page_lo + lo // self.page_words
        p_hi = ga.page_lo + (max(hi - 1, lo)) // self.page_words + 1
        arr_end = ga.page_lo + -(-ga.n_elems // self.page_words)
        p_hi = max(min(p_hi + self.prefetch, arr_end), p_hi)  # prefetch
        self._fetch_range(w, region, p_lo, p_hi)

    def write(self, w: int, ga: GasArray, lo: int, hi: int):
        region = self._region_of(ga.page_lo)
        p_lo = ga.page_lo + lo // self.page_words
        p_hi = ga.page_lo + (max(hi - 1, lo)) // self.page_words + 1
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
        d.valid[w, s] = True

        if in_span:
            span = self.spans[w][-1]
            if span.plane:
                self._span_note(w, span, d, region, ga, lo, hi, p_lo, p_hi)
            else:
                for p in range(p_lo, p_hi):
                    wlo, whi = ga.word_range_in_page(p, lo, hi)
                    old = span.touched.get(p)
                    span.touched[p] = ((min(wlo, old[0]), max(whi, old[1]))
                                       if old else (wlo, whi))
        else:
            d.dirty[w, s] = True
            d.maybe_dirty = True
            self._dirty_regions[w].add(region)

    # ------------------------------------------------------------------
    # ordinary flush (page granularity in both protocols)
    # ------------------------------------------------------------------

    def _count_invalidations(self, n_inv: int):
        if n_inv:
            self.traffic.invalidations += n_inv
            self.traffic.control_msgs += n_inv

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

    def _flush_all_workers(self):
        """Batched flush of every worker's ordinary-dirty pages (the
        barrier), one pass per region that reproduces the sequential
        worker-order flush semantics analytically: for a page with
        dirty-worker set D (flushed in worker order) and initial valid
        set V, the sequential flushes produce ``|V \\ {d0}| +
        [|D|>1]*[d0 in V]`` invalidations and leave the page valid only at
        d0 when ``|D|==1``.  Pages under a single worker window have no
        sharer, so per-cell work is confined to multiply-covered pages.

        On 'fused' one ``phase_step`` launch reduces every dirty region
        (popcount, coverage stab, candidate mask); the other tiers reduce
        region by region.  Charging, wprot re-arm and the analytic
        invalidation stay on the host and are identical on every tier."""
        counts = shared = None
        ji = 0
        if self.backend == "fused" and self.protocol != IDEAL_PROTO:
            cand = [d for d in self.dirs if d.maybe_dirty and d.cap > 0]
            if cand:
                counts, shared = self._jit_flush_chain(cand)
        for d in self.dirs:
            if not d.maybe_dirty:
                continue
            if counts is not None and d.cap > 0:
                nD_w = counts[ji]          # fused chain output
                sub_bits = shared[ji]
                ji += 1
            else:
                nD_w = d.dirty_counts()
                sub_bits = None
            total = int(nD_w.sum())
            d.maybe_dirty = False
            d.clear_dirty_bounds()
            if total == 0:
                continue
            if self.protocol == IDEAL_PROTO:
                d.dirty.zero_()
                continue
            active = np.nonzero(nD_w)[0]
            # per-(worker, region) writeback charge, as in the sequential
            # flush: one batched message group per worker window
            self.traffic.writeback_bytes += total * self.page_bytes
            msgs = -(-nD_w[active] // self.fetch_batch)
            self.clock[active] += (self.cost.net_latency_s * msgs
                                   + (nD_w[active] * self.page_bytes)
                                   / self.cost.net_bw_Bps)
            if d.wprot is not None:
                torch.logical_or(d.wprot, d.dirty, out=d.wprot)  # re-arm
            if sub_bits is not None:
                w_idx, cols = self._shared_cells(sub_bits[d.ix(active)])
                w_idx = active[w_idx]
            else:
                w_idx, cols = self._shared_dirty_sweep(d, active)
            if w_idx.size:
                self._invalidate_shared_dirty(d, w_idx, cols)
            d.dirty.zero_()
        for regions in self._dirty_regions:
            regions.clear()

    @staticmethod
    def _shared_cells(sub_bits: torch.Tensor):
        """(row, column) host pairs of the set bits of packed candidate
        masks, row-major and column-ascending — the sequential
        worker-major flush order.  Only the nonzero words cross to the
        host."""
        nz = torch.nonzero(sub_bits)
        if nz.numel() == 0:
            z = np.zeros(0, np.int64)
            return z, z
        words = sub_bits[nz[:, 0], nz[:, 1]]
        host = torch.cat([nz, words.to(torch.int64)[:, None]],
                         dim=1).cpu().numpy()
        bits = ((host[:, 2:3] & 0xFFFFFFFF) >> np.arange(32)) & 1
        mi, j = np.nonzero(bits)
        return host[mi, 0], 32 * host[mi, 1] + j

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

    def _jit_flush_chain(self, cand):
        """Pack every dirty region's plane into one (R, W, nw) stack (R
        ``pack_rows`` launches) and run the fused flush as ONE
        ``phase_step`` launch.  Returns host per-region per-row dirty
        counts and the device packed shared-dirty candidate masks, or
        (None, None) when page ids could overflow the kernel's int32
        arithmetic — the caller then takes the kernel tier's
        ``popcount_rows``/``coverage_multi`` path."""
        R, W = len(cand), self.W
        nw_max = max(-(-int(d.cap) // 32) for d in cand)
        # page = base + col with col < nw_max*32 must stay below the
        # INT32_MAX pads
        if max(int(d.page_hi) for d in cand) + nw_max * 32 >= (1 << 31) - 1:
            return None, None
        bits = torch.empty((R, W, nw_max), dtype=torch.int32,
                           device=self.device)
        for i, d in enumerate(cand):
            _ps.pack_rows(d.dirty, out=bits[i])
        # each region's geometry stays on the device until its windows
        # change; only the stacking across regions runs per flush
        geom_t = torch.stack([d.jit_geometry_tensor() for d in cand], dim=1)
        rowmask = torch.ones((R, W), dtype=torch.bool, device=self.device)
        counts, shared = _ps.phase_step(bits, geom_t[0], rowmask,
                                        geom_t[1], geom_t[2])
        self.stats["fused_dispatches"] += 1
        return counts.cpu().numpy(), shared

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
            else:
                n_inv = self._replay_invalidate(
                    w, u, rearm=self.model_mechanism)
                self.traffic.invalidations += n_inv
                self.traffic.control_msgs += int(u.size)
        lk.seen[w] = lk.version
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
            self._fetch_dense(d, p_lo, p_hi, rows)
            return
        c0 = p_lo - d.base[rows]
        uk, inv = np.unique(np.stack([c0, L], axis=1), axis=0,
                            return_inverse=True)
        inv = inv.reshape(-1)
        for g in range(uk.shape[0]):
            self._fetch_uniform(d, rows[inv == g], int(uk[g, 0]),
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
        return tot_miss

    def _fetch_uniform(self, d: RegionDirectory, rows: np.ndarray, c0: int,
                       n: int):
        """One uniform-span fetch group: all ``rows`` fetch columns
        [c0, c0+n) of their windows — 2D slice ops, no gather."""
        s = slice(c0, c0 + n)
        rb = d.row_block(rows)
        n_miss = n - d.valid[rb, s].sum(dim=1).cpu().numpy()
        if self._charge_misses(rows, n_miss):
            d.valid[rb, s] = True

    def _fetch_dense(self, d: RegionDirectory, p_lo: np.ndarray,
                     p_hi: np.ndarray, rows: np.ndarray):
        cols, mask = d.range_cols(p_lo, p_hi, rows)
        r2 = d.ix(rows)[:, None]
        c2 = d.ix(np.where(mask, cols, 0))
        vsub = d.valid[r2, c2].cpu().numpy() & mask
        n_miss = (p_hi - p_lo) - vsub.sum(axis=1)
        if self._charge_misses(rows, n_miss):
            ri, ci = np.nonzero(mask & ~vsub)
            d.valid[d.ix(rows[ri]), d.ix(cols[ri, ci])] = True

    def _read_all(self, ga, lo: np.ndarray, hi: np.ndarray):
        region, p_lo, p_hi = self._page_range_all(ga, lo, hi, prefetch=True)
        self._fetch_range_all(region, p_lo, p_hi, self._rows_all)

    def _write_all(self, ga, lo: np.ndarray, hi: np.ndarray):
        region, p_lo, p_hi = self._page_range_all(ga, lo, hi, prefetch=False)
        d = self.dirs[region]
        rows = self._rows_all
        d.ensure_rows(p_lo, p_hi, rows)
        d.note_dirty(rows, p_lo, p_hi)
        L = p_hi - p_lo
        if use_dense(rows.size, int(L.max())):
            self._write_dense(d, region, lo, hi, p_lo, p_hi, rows)
        else:
            c0 = p_lo - d.base[rows]
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
        d.valid[rb, s] = True
        d.dirty[rb, s] = True

    def phase_all(self, reads=(), writes=(), *, flops=0.0, mem_bytes=0.0,
                  seconds=0.0, instr_words=0.0):
        """One SPMD phase for ALL workers in a single runtime call.

        ``reads``/``writes`` are sequences of ``(ga, lo, hi)`` with
        ``lo``/``hi`` as (W,) int arrays (scalars broadcast);
        ``flops``/``mem_bytes``/``seconds``/``instr_words`` may be scalars
        or (W,) arrays.  Bit-exactly equivalent to
        ``for w in range(W): phase(w, ...)``: without eviction, workers
        do not interact within a phase, so ops run op-major as single
        vectorized passes over the (W, window) planes.  Must be called
        outside spans."""
        if any(self.spans):
            raise RuntimeError("phase_all must run outside spans")
        self._phase_idx += 1
        W = self.W
        reads = [(ga, self._w_arr(lo), self._w_arr(hi))
                 for ga, lo, hi in reads]
        writes = [(ga, self._w_arr(lo), self._w_arr(hi))
                  for ga, lo, hi in writes]
        self.stats["batched_phases"] += 1
        for ga, lo, hi in reads:
            self._read_all(ga, lo, hi)
        for ga, lo, hi in writes:
            self._write_all(ga, lo, hi)
        fl = np.asarray(flops, np.float64)
        mb = np.asarray(mem_bytes, np.float64)
        sec = np.asarray(seconds, np.float64)
        iw = np.asarray(instr_words, np.float64)
        if fl.any() or mb.any() or sec.any():
            sharing = self.cost.workers_on_node(W)
            bw = self.cost.node_bw(sharing) / max(1, sharing)
            self.clock += np.broadcast_to(
                sec + np.maximum(fl / self.cost.flops_per_worker, mb / bw),
                (W,))
        if self.model_mechanism and self.protocol == FINE_PROTO and iw.any():
            self.clock += np.broadcast_to(iw * self.instr_s_per_word, (W,))

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
        self._phase_idx += 1
        self._flush_all_workers()
        if self.protocol != IDEAL_PROTO:
            for lk in self.locks.values():
                if (lk.seen == lk.version).all():
                    continue       # everyone current (usual post-span state)
                for w in range(self.W):
                    if lk.seen[w] == lk.version:
                        continue
                    u, lo_u, hi_u = lk.log.pending(int(lk.seen[w]),
                                                   lk.version)
                    lk.seen[w] = lk.version
                    if not u.size:
                        continue
                    if self.protocol == FINE_PROTO:
                        self.traffic.diff_bytes += self._stale_diff_bytes(
                            w, u, lo_u, hi_u)
                    else:
                        self.traffic.invalidations += self._replay_invalidate(
                            w, u, rearm=False)
        log_w = max(1, int(np.ceil(np.log2(max(self.W, 2)))))
        for name, contribs in self._reductions.items():
            vals = [v for v, _ in contribs]
            op = contribs[0][1]
            fn = {"sum": np.sum, "max": np.max, "min": np.min}[op]
            self._reduction_results[name] = float(fn(vals))
            self.traffic.reduction_msgs += self.W - 1
        self._reductions.clear()
        t = float(self.clock.max()) + self.cost.net_latency_s * log_w * (
            0 if self.protocol == IDEAL_PROTO else 1) + 1e-7 * log_w
        self.clock[:] = t
        self._bar_clock0 = self.clock.copy()

    def _stale_diff_bytes(self, w: int, u: np.ndarray, lo_u: np.ndarray,
                          hi_u: np.ndarray) -> int:
        """Fine-grain barrier update: diff bytes for w's valid stale
        copies of the noticed pages ``u`` only."""
        total = 0
        regions = np.searchsorted(self._region_starts_np, u, "right") - 1
        for r in np.unique(regions):
            d = self.dirs[int(r)]
            if d.base[w] < 0:
                continue
            m = regions == r
            cols = u[m] - d.base[w]
            inr = (cols >= 0) & (cols < d.length[w])
            vcells = (d.valid[w, d.ix(np.where(inr, cols, 0))].cpu().numpy()
                      & inr)
            total += int(((hi_u[m] - lo_u[m]) * _WORD)[vcells].sum())
        return total

    @property
    def time(self) -> float:
        return float(self.clock.max())
