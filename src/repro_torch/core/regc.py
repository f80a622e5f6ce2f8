"""Regional Consistency (RegC): the per-page reference engine and the data
types shared by the RegC runtimes (the exact traffic ledger and the
global-address-space allocation handle).

``RegCRuntime`` is the reference package's per-page protocol oracle: the
two region kinds (ordinary / consistency), spans, the three visibility
rules (paper §III-A), both Samhita protocols (page invalidation vs fine
diffs), the reduction extension (§V-B), per-worker caches with LRU and
sequential prefetch, and the scalar race oracle.  Every event walks its
pages one by one in the reference's order, so traffic is equal field for
field and clocks are bit-equal to the reference's.

Two value modes, as in the reference:

* ``track_values=True`` -- page data is materialized on the runtime's
  device: ``home`` is one (n_pages, page_words) float32 tensor, and the
  cached copies, the span twins and the word-exact ordinary dirty masks
  (int8) are (page_words,) tensors beside it.  A fine-protocol release
  diffs the span's pages against their twins in one ``diff_encode``
  launch and merges them onto home in place with one
  ``diff_apply_rows_``; the ordinary flush merges its dirty words onto
  home in place (``diff_apply_``), and the false-sharing overlay onto a
  fresh copy of home (``diff_apply``), which must stay as it is.
  ``read`` returns a tensor on the device; ``write`` takes its values as
  one (a host array is copied over once per call).
* ``track_values=False`` -- metadata only: writes record word intervals
  and diff bytes are exact for interval writes.

The protocol metadata stays on the host in both modes, since every
operation reads it page by page: ``valid``, the LRU dicts, the dirty
intervals, the lock notices, versions and ``seen``, the clocks, the
traffic and the race clocks.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import (FINE_PROTO, IDEAL_PROTO, PROTOCOLS,
                                     check_choice, resolve_device)
from repro_torch.dsm.costmodel import CostModel, IB_2013
from repro_torch.kernels.page_diff import (diff_apply, diff_apply_,
                                           diff_apply_rows_, diff_encode)

_WORD = 4  # fp32 words


@dataclasses.dataclass
class Traffic:
    page_fetches: int = 0
    fetch_bytes: int = 0
    writeback_bytes: int = 0
    diff_bytes: int = 0
    invalidations: int = 0
    control_msgs: int = 0
    reduction_msgs: int = 0

    @property
    def total_bytes(self) -> int:
        return self.fetch_bytes + self.writeback_bytes + self.diff_bytes

    def add(self, other: "Traffic"):
        for f in dataclasses.fields(Traffic):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class GasArray:
    """Handle to a page-aligned allocation in the global address space."""
    page_lo: int
    n_elems: int
    page_words: int

    def pages_of(self, lo: int, hi: int) -> range:
        return range(self.page_lo + lo // self.page_words,
                     self.page_lo + (max(hi - 1, lo)) // self.page_words + 1)

    def word_range_in_page(self, p: int, lo: int, hi: int) -> Tuple[int, int]:
        base = (p - self.page_lo) * self.page_words
        return max(lo - base, 0), min(hi - base, self.page_words)


class _Span:
    __slots__ = ("lock", "touched", "twins")

    def __init__(self, lock: int):
        self.lock = lock
        self.touched: Dict[int, Tuple[int, int]] = {}   # page -> (lo, hi)
        self.twins: Dict[int, torch.Tensor] = {}


class _Lock:
    __slots__ = ("version", "notices", "last_release_time", "seen",
                 "race_vc")

    def __init__(self, n_workers: int):
        self.version = 0
        # notices[i] = [(page, lo, hi, None), ...] of release version i+1
        self.notices: List[List[Tuple[int, int, int, None]]] = []
        self.last_release_time = 0.0
        self.seen = np.zeros(n_workers, np.int64)
        # race detection: the lock's vector clock (join of every releaser)
        self.race_vc = np.zeros(n_workers, np.int64)


class RegCRuntime:
    """The Samhita-analogue per-page DSM runtime implementing RegC."""

    def __init__(self, n_workers: int, *, page_words: int = 1024,
                 protocol: str = FINE_PROTO, cost: CostModel = IB_2013,
                 track_values: bool = True, cache_pages: Optional[int] = None,
                 prefetch: int = 1, detect_races: bool = False,
                 device=None):
        check_choice("protocol", protocol, PROTOCOLS)
        self.device = resolve_device(device)
        self.W = n_workers
        self.page_words = page_words
        self.page_bytes = page_words * _WORD
        self.protocol = protocol
        self.cost = cost
        self.track_values = track_values
        self.cache_pages = cache_pages
        self.prefetch = prefetch

        self.n_pages = 0
        self.home: Optional[torch.Tensor] = None     # (n_pages, page_words)
        self.cache_data: Dict[Tuple[int, int], torch.Tensor] = {}
        self.valid = np.zeros((n_workers, 0), bool)
        self.lru: List[OrderedDict] = [OrderedDict() for _ in range(n_workers)]
        # ordinary-region dirty intervals, page -> (lo, hi) per worker, in
        # the reference's insertion order (its one (w, page) dict read one
        # worker at a time)
        self.ord_dirty: List[Dict[int, Tuple[int, int]]] = [
            {} for _ in range(n_workers)]
        # word-exact dirty masks (track_values only), int8 on the device:
        # false-sharing merges need per-word resolution
        self.ord_mask: Dict[Tuple[int, int], torch.Tensor] = {}
        self.spans: List[List[_Span]] = [[] for _ in range(n_workers)]
        self.locks: Dict[int, _Lock] = {}
        self.clock = np.zeros(n_workers)
        self.traffic = Traffic()
        self.per_worker_traffic = [Traffic() for _ in range(n_workers)]
        self._reductions: Dict[str, List[Tuple[float, str]]] = {}
        self._reduction_results: Dict[str, float] = {}
        self._barrier_count = 0
        # race detection (pure observer: never touches traffic or clocks):
        # per-worker vector clocks, page-granular last-access epochs, and
        # the flagged set {(page, a, b, kind)} with a < b, kind "ww"/"rw"
        self.detect_races = detect_races
        self.race_vc = (np.eye(n_workers, dtype=np.int64)
                        if detect_races else None)
        self._race_wpage: Dict[int, np.ndarray] = {}
        self._race_rpage: Dict[int, np.ndarray] = {}
        self.races: set = set()

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------

    def alloc(self, n_elems: int) -> GasArray:
        pages = -(-n_elems // self.page_words)
        ga = GasArray(self.n_pages, n_elems, self.page_words)
        self.n_pages += pages
        if self.track_values:
            new = torch.zeros((self.n_pages, self.page_words),
                              dtype=torch.float32, device=self.device)
            if self.home is not None:
                new[: self.home.shape[0]] = self.home
            self.home = new
        self.valid = np.pad(self.valid,
                            ((0, 0), (0, self.n_pages - self.valid.shape[1])))
        return ga

    # ------------------------------------------------------------------
    # cost helpers
    # ------------------------------------------------------------------

    def _sharing(self) -> int:
        return self.cost.workers_on_node(self.W)

    def _net(self, w: int, n_bytes: float, msgs: int = 1):
        if self.protocol == IDEAL_PROTO:
            return
        self.clock[w] += self.cost.xfer_s(n_bytes, msgs)

    def compute(self, w: int, *, flops: float = 0.0, mem_bytes: float = 0.0,
                seconds: float = 0.0):
        self.clock[w] += seconds + self.cost.compute_s(
            flops, mem_bytes, self._sharing())

    def instr_stores(self, w: int, n_words: float):
        """Mechanism-cost hook (modeled only by the scale engine)."""

    # ------------------------------------------------------------------
    # page values
    # ------------------------------------------------------------------

    def _values(self, values) -> torch.Tensor:
        if isinstance(values, torch.Tensor):
            dev = self.device
            if values.device.type != dev.type or (
                    dev.index is not None and values.device.index != dev.index):
                raise ValueError(f"write values are on {values.device}, "
                                 f"the runtime on {self.device}")
            return values.to(torch.float32)
        return torch.as_tensor(np.asarray(values, np.float32),
                               device=self.device)

    # ------------------------------------------------------------------
    # cache internals
    # ------------------------------------------------------------------

    def _touch_lru(self, w: int, p: int):
        if self.cache_pages is None:
            return
        lru = self.lru[w]
        lru.pop(p, None)
        lru[p] = True
        while len(lru) > self.cache_pages:
            victim, _ = lru.popitem(last=False)
            # dirty victims write back before eviction
            if victim in self.ord_dirty[w]:
                self._flush_page_ordinary(w, victim)
            self.valid[w, victim] = False
            self.cache_data.pop((w, victim), None)

    def _fetch(self, w: int, p: int):
        if self.valid[w, p]:
            self._touch_lru(w, p)
            return
        if self.protocol != IDEAL_PROTO:
            self.traffic.page_fetches += 1
            self.traffic.fetch_bytes += self.page_bytes
            self.per_worker_traffic[w].page_fetches += 1
            self.per_worker_traffic[w].fetch_bytes += self.page_bytes
            self._net(w, self.page_bytes, 2)  # request + reply
        if self.track_values:
            # false sharing: if our stale copy carries pending ordinary
            # stores (invalidated-while-dirty), overlay them word-exactly
            # on the fresh home copy; DRF programs write disjoint words
            mask = self.ord_mask.get((w, p))
            stale = self.cache_data.get((w, p))
            if mask is not None and stale is not None:
                fresh = diff_apply(self.home[p], mask, stale)
            else:
                fresh = self.home[p].clone()
            self.cache_data[(w, p)] = fresh
        self.valid[w, p] = True
        self._touch_lru(w, p)

    def _page_view(self, w: int, p: int) -> torch.Tensor:
        if self.protocol == IDEAL_PROTO:
            return self.home[p]          # a view: stores land on home
        return self.cache_data[(w, p)]

    # ------------------------------------------------------------------
    # race detection (scalar oracle; page-granular epoch vector clocks)
    # ------------------------------------------------------------------

    def _race_record(self, p: int, w: int, u: int, kind: str):
        a, b = (w, u) if w < u else (u, w)
        self.races.add((p, a, b, kind))

    def _race_access(self, w: int, ga: GasArray, lo: int, hi: int,
                     is_write: bool):
        """Check-then-record one declared access against the per-page
        last-access epochs, at op granularity over the declared [lo, hi)
        range: the cache path never changes the race set."""
        if not self.detect_races:
            return
        vc = self.race_vc
        for p in ga.pages_of(lo, hi):
            wvc = self._race_wpage.get(p)
            if wvc is not None:
                for u in np.nonzero(wvc > vc[w])[0]:
                    self._race_record(p, w, int(u),
                                      "ww" if is_write else "rw")
            if is_write:
                rvc = self._race_rpage.get(p)
                if rvc is not None:
                    for u in np.nonzero(rvc > vc[w])[0]:
                        self._race_record(p, w, int(u), "rw")
                tgt = self._race_wpage.setdefault(
                    p, np.zeros(self.W, np.int64))
            else:
                tgt = self._race_rpage.setdefault(
                    p, np.zeros(self.W, np.int64))
            tgt[w] = vc[w, w]

    @property
    def race_counts(self) -> Dict[str, int]:
        return {"race_ww": sum(1 for r in self.races if r[3] == "ww"),
                "race_rw": sum(1 for r in self.races if r[3] == "rw")}

    # ------------------------------------------------------------------
    # reads / writes
    # ------------------------------------------------------------------

    def read(self, w: int, ga: GasArray, lo: int,
             hi: int) -> Optional[torch.Tensor]:
        self._race_access(w, ga, lo, hi, False)
        pages = list(ga.pages_of(lo, hi))
        for p in pages:
            self._fetch(w, p)
        # sequential prefetch (paper §V-A cache-spill result)
        for q in range(pages[-1] + 1,
                       min(pages[-1] + 1 + self.prefetch,
                           ga.page_lo + -(-ga.n_elems // self.page_words))):
            self._fetch(w, q)
        if not self.track_values:
            return None
        flat = torch.cat([self._page_view(w, p) for p in pages])
        base = lo - (pages[0] - ga.page_lo) * self.page_words
        return flat[base: base + (hi - lo)]

    def write(self, w: int, ga: GasArray, lo: int, hi: int, values=None):
        self._race_access(w, ga, lo, hi, True)
        if self.track_values and values is not None:
            values = self._values(values)
        pages = list(ga.pages_of(lo, hi))
        in_span = bool(self.spans[w])
        for p in pages:
            wlo, whi = ga.word_range_in_page(p, lo, hi)
            partial = (whi - wlo) < self.page_words
            if self.protocol != IDEAL_PROTO:
                if partial or self.track_values:
                    self._fetch(w, p)      # write-allocate
                else:
                    self.valid[w, p] = True
                    self._touch_lru(w, p)
            if in_span:
                span = self.spans[w][-1]
                if self.track_values and p not in span.twins:
                    span.twins[p] = self._page_view(w, p).clone()
                old = span.touched.get(p)
                span.touched[p] = (min(wlo, old[0]) if old else wlo,
                                   max(whi, old[1]) if old else whi)
            else:
                dirty = self.ord_dirty[w]
                old = dirty.get(p)
                dirty[p] = (min(wlo, old[0]) if old else wlo,
                            max(whi, old[1]) if old else whi)
                if self.track_values:
                    mask = self.ord_mask.get((w, p))
                    if mask is None:
                        mask = self.ord_mask[(w, p)] = torch.zeros(
                            self.page_words, dtype=torch.int8,
                            device=self.device)
                    mask[wlo:whi] = 1
            if self.track_values and values is not None:
                # page p's words [wlo, whi) take values[wlo - off, whi -
                # off); off <= wlo always, so the reference's other branch
                # never runs.  Under IDEAL_PROTO the view is home's row.
                off = lo - (p - ga.page_lo) * self.page_words
                self._page_view(w, p)[wlo:whi] = values[wlo - off:
                                                        whi - off]

    # ------------------------------------------------------------------
    # ordinary-region flush (page-granularity in BOTH protocols, per paper)
    # ------------------------------------------------------------------

    def _flush_page_ordinary(self, w: int, p: int):
        self.ord_dirty[w].pop(p, None)
        if self.protocol == IDEAL_PROTO:
            return
        self.traffic.writeback_bytes += self.page_bytes
        self.per_worker_traffic[w].writeback_bytes += self.page_bytes
        self._net(w, self.page_bytes, 1)
        mask = self.ord_mask.pop((w, p), None)
        cached = self.cache_data.get((w, p)) if self.track_values else None
        if cached is not None:
            if mask is not None:
                # merge ONLY our dirty words: concurrent disjoint writers
                # of the same page (false sharing) must not clobber each
                # other's words at the home copy; merged in place
                diff_apply_(self.home[p], mask, cached)
            else:
                self.home[p] = cached
        # invalidate other cached copies; a sharer that is itself DIRTY on
        # this page keeps its data (its own stores are still pending: they
        # overlay the fresh home copy on its next fetch)
        sharers = [int(v) for v in np.flatnonzero(self.valid[:, p])
                   if v != w]
        self.traffic.invalidations += len(sharers)
        self.traffic.control_msgs += len(sharers)
        for v in sharers:
            self.valid[v, p] = False
            if p not in self.ord_dirty[v]:
                self.cache_data.pop((v, p), None)

    def _flush_ordinary(self, w: int):
        for p in list(self.ord_dirty[w]):
            self._flush_page_ordinary(w, p)

    # ------------------------------------------------------------------
    # spans (consistency regions)
    # ------------------------------------------------------------------

    def _pending(self, lk: _Lock, w: int) -> Dict[int, Tuple[int, int]]:
        """Notices of ``lk`` released since ``w`` last synced, coalesced
        per page into one word interval."""
        pending: Dict[int, Tuple[int, int]] = {}
        for ver in range(int(lk.seen[w]), lk.version):
            for (p, lo, hi, _vals) in lk.notices[ver]:
                old = pending.get(p)
                pending[p] = ((min(lo, old[0]), max(hi, old[1]))
                              if old else (lo, hi))
        return pending

    def acquire(self, w: int, lock_id: int):
        lk = self.locks.setdefault(lock_id, _Lock(self.W))
        # RegC rule 1: ordinary stores performed at w before this span must
        # be performed wrt every worker whose span starts subsequently
        self._flush_ordinary(w)
        # lock grant serializes spans (resource manager round trip)
        self._net(w, 64, 2)
        self.traffic.control_msgs += 2
        self.clock[w] = max(self.clock[w], lk.last_release_time)
        # RegC rule 2: consistent STOREs previously performed wrt this
        # consistency region must be performed wrt w; pending notices are
        # coalesced per page
        for p, (lo, hi) in sorted(self._pending(lk, w).items()):
            if self.protocol == FINE_PROTO:
                # fine-grain update: ship only the merged diff
                nbytes = (hi - lo) * _WORD + self.page_words // 8
                self.traffic.diff_bytes += nbytes
                self.per_worker_traffic[w].diff_bytes += nbytes
                self._net(w, nbytes, 1)
                if self.track_values and self.valid[w, p]:
                    self._page_view(w, p)[lo:hi] = self.home[p, lo:hi]
            else:
                # page protocol: invalidate; next read refetches the page
                if self.valid[w, p]:
                    self.valid[w, p] = False
                    self.cache_data.pop((w, p), None)
                    self.traffic.invalidations += 1
                self.traffic.control_msgs += 1
        lk.seen[w] = lk.version
        if self.detect_races:
            # happens-before: every prior release of this lock precedes us
            np.maximum(self.race_vc[w], lk.race_vc, out=self.race_vc[w])
        self.spans[w].append(_Span(lock_id))

    def _diff_span(self, w: int, span: _Span, pages: List[int]):
        """The fine release's twin diff of ``pages`` (sorted) in one
        ``diff_encode`` launch, merged onto home's rows in place with one
        ``diff_apply_rows_``.
        Returns host (count, first changed word, last changed word) per
        page, the kernel's stats block read back in one copy (first/last
        are meaningless where the count is 0)."""
        curr = torch.stack([self._page_view(w, p) for p in pages])
        twin = torch.stack([span.twins[p] for p in pages])
        mask, vals, stats = diff_encode(curr, twin, bounds=True)
        # vals equals curr wherever the mask is set, so the merge is the
        # reference's home[p][mask] = curr[mask], bit for bit
        rows = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        diff_apply_rows_(self.home, rows, mask, vals)
        return stats.cpu().numpy()

    def release(self, w: int, lock_id: int):
        span = self.spans[w].pop()
        if span.lock != lock_id:
            raise RuntimeError(f"unbalanced lock release: worker {w} "
                               f"releases {lock_id}, holds {span.lock}")
        lk = self.locks[lock_id]
        notices = []
        touched = sorted(span.touched.items())
        diffs = None
        if (self.protocol == FINE_PROTO and self.track_values and touched):
            diffs = self._diff_span(w, span, [p for p, _ in touched])
        for i, (p, (lo, hi)) in enumerate(touched):
            if self.protocol == IDEAL_PROTO:
                continue
            if diffs is not None:
                nwords = int(diffs[0, i])
                if nwords:
                    lo, hi = int(diffs[1, i]), int(diffs[2, i]) + 1
                else:
                    hi = lo
                nbytes = nwords * _WORD + self.page_words // 8
            elif self.protocol == FINE_PROTO:
                nbytes = (hi - lo) * _WORD + self.page_words // 8
            else:  # PAGE protocol: whole-page writeback
                nbytes = self.page_bytes
                if self.track_values:
                    self.home[p] = self._page_view(w, p)
            if self.protocol == FINE_PROTO:
                self.traffic.diff_bytes += nbytes
                self.per_worker_traffic[w].diff_bytes += nbytes
            else:
                self.traffic.writeback_bytes += nbytes
                self.per_worker_traffic[w].writeback_bytes += nbytes
            self._net(w, nbytes, 1)
            notices.append((p, lo, hi, None))
        if self.protocol != IDEAL_PROTO:
            lk.notices.append(notices)
            lk.version += 1
            lk.seen[w] = lk.version
        self._net(w, 64, 1)
        self.traffic.control_msgs += 1
        lk.last_release_time = self.clock[w]
        if self.detect_races:
            # publish our clock into the lock, then start a fresh epoch
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

    def span(self, w: int, lock_id: int) -> "_SpanCtx":
        return self._SpanCtx(self, w, lock_id)

    # ------------------------------------------------------------------
    # the reduction extension (paper §V-B)
    # ------------------------------------------------------------------

    def reduce(self, w: int, name: str, value: float, op: str = "sum"):
        """Runtime-implemented reduction replacing a mutex-protected
        accumulation.  Contributions combine at the next barrier in a
        log-tree (object granularity, never a page)."""
        self._reductions.setdefault(name, []).append((float(value), op))

    def reduction_result(self, name: str) -> float:
        return self._reduction_results[name]

    # ------------------------------------------------------------------
    # barrier (RegC rule 3)
    # ------------------------------------------------------------------

    def barrier(self):
        self._barrier_count += 1
        for w in range(self.W):
            self._flush_ordinary(w)
        if self.protocol != IDEAL_PROTO:
            # stale copies were invalidated at each flush; the barrier
            # adds the notice sync for every lock
            for lk in self.locks.values():
                for w in range(self.W):
                    for p, (lo, hi) in sorted(self._pending(lk, w).items()):
                        if not self.valid[w, p]:
                            continue
                        if self.protocol == FINE_PROTO:
                            # fine-grain update of the stale copy
                            if self.track_values:
                                self.cache_data[(w, p)][lo:hi] = \
                                    self.home[p, lo:hi]
                            self.traffic.diff_bytes += (hi - lo) * _WORD
                        else:
                            self.valid[w, p] = False
                            self.cache_data.pop((w, p), None)
                            self.traffic.invalidations += 1
                    lk.seen[w] = lk.version
        # reductions combine in a log-tree
        log_w = max(1, int(np.ceil(np.log2(max(self.W, 2)))))
        for name, contribs in self._reductions.items():
            vals = [v for v, _ in contribs]
            fn = {"sum": np.sum, "max": np.max, "min": np.min}[contribs[0][1]]
            self._reduction_results[name] = float(fn(vals))
            self.traffic.reduction_msgs += self.W - 1
        self._reductions.clear()
        if self.detect_races:
            # the barrier joins every worker's clock, then each worker
            # starts a fresh epoch
            j = self.race_vc.max(axis=0)
            self.race_vc[:] = j[None, :]
            self.race_vc[np.arange(self.W), np.arange(self.W)] += 1
        # clocks join (+ tree latency)
        t = float(self.clock.max()) + self.cost.net_latency_s * log_w * (
            0 if self.protocol == IDEAL_PROTO else 1) + 1e-7 * log_w
        self.clock[:] = t

    # ------------------------------------------------------------------
    @property
    def time(self) -> float:
        return float(self.clock.max())
