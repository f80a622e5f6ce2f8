"""Region-level sharing directory for the vectorized RegC protocol engine.

``RegionDirectory`` turns the worker axis into a tensor axis: one object
per allocation region holds ``valid`` / ``dirty`` / ``wprot`` as
``(W, cap)`` torch bool planes on the runtime's device, and under
``cache_pages`` the LRU planes ``touch`` (int64 run ticks) and ``incache``
(bool cache occupancy) beside them.  Rows are workers;
every row carries its own base offset (column ``j`` of row ``w`` is
absolute page ``base[w] + j``), so memory stays O(pages actually touched)
while cross-worker protocol events become single gather/scatter ops over
the worker axis.

Only the planes live on the device.  The window geometry (``base``,
``length``, ``shift``, ``cap``) and the conservative dirty bounds
(``dirty_lo``/``dirty_hi``) are host-side int64 numpy, the authoritative
copy: the engine reads them per row and per op, and a device copy would
turn each read into a synchronisation.  Methods take and return host
numpy index arrays and counts; they move index tensors to the device
only to gather or scatter plane cells.

Under ``detect_races`` two int64 vector-clock planes join them
(``race_w``/``race_r``, the write and read halves of one (2, W, cap)
tensor) with their per-row running maxima on the host, the screens that
keep the card out of a check that cannot fire.

``IntervalLog`` is the per-lock notice log: a flat, version-segmented
``(page, lo, hi)`` host array with a per-page segment min/max coalesce.

Every method here is a representation change of the reference's
``repro.core.directory`` with the same results cell for cell; the parity
tests hold the two against each other on seeded inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import resolve_device
from repro_torch.kernels import protocol_sweep as _ps

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min
_I32_MAX = np.iinfo(np.int32).max


def host(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of ``t`` that shares no memory with it: on the CPU
    ``.cpu().numpy()`` of a plane slice would alias the plane, and later
    plane updates would show through."""
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def use_dense(n_rows: int, l_max: int) -> bool:
    """Strategy pick for per-op batched plane updates: dense (rows x Lmax)
    gather/scatter matrices for many narrow intervals or tiny ops;
    per-group contiguous slice ops otherwise.  Both charge identically,
    so the cutoff is invisible to traffic and clocks."""
    return l_max <= 512 or n_rows * l_max <= (1 << 16)


class RegionDirectory:
    """2D per-worker page state of one allocation region.

    Cells outside a row's live window ``[0, length[w])`` always hold the
    init values (valid=False, dirty=False, wprot=True, touch=0,
    incache=False), so window extension to the right is free and
    whole-plane reductions are safe.
    """

    __slots__ = ("W", "region", "page_lo", "page_hi", "device", "base",
                 "length", "cap", "valid", "dirty", "wprot", "touch",
                 "incache", "shift",
                 "maybe_dirty", "_cov_stale", "_sorted_bases",
                 "_sorted_ends", "backend", "dirty_lo", "dirty_hi",
                 "span_lo", "span_hi", "stats", "_jit_geom", "_jit_geom_t",
                 "_cov_bounds_t", "_race", "race_maxw", "race_maxr")

    # cells a batched race check gathers per round trip (bounds the host
    # index arrays and the device gather of a wide check)
    RACE_CELLS = 1 << 22

    def __init__(self, n_workers: int, region: int, page_lo: int,
                 page_hi: int, *, track_wprot: bool = False,
                 track_touch: bool = False, backend: str = "fused",
                 device=None):
        self.W = n_workers
        self.region = region
        self.page_lo = page_lo
        self.page_hi = page_hi
        # None means the card, as for the runtime; no card raises
        self.device = resolve_device(device, backend)
        self.base = np.full(n_workers, -1, np.int64)
        self.length = np.zeros(n_workers, np.int64)
        self.cap = 0
        self.valid = self._plane(0, False)
        self.dirty = self._plane(0, False)
        self.wprot = self._plane(0, True) if track_wprot else None
        # LRU bookkeeping (cache_pages runs only): the touch tick of each
        # cell's run, and cache occupancy, which differs from ``valid``:
        # an invalidated page keeps its cache slot until it is evicted
        self.touch = (self._plane(0, 0, torch.int64) if track_touch
                      else None)
        self.incache = self._plane(0, False) if track_touch else None
        # cumulative left-extension shift per row (maps LRU queue entries
        # recorded before a left growth to current columns)
        self.shift = np.zeros(n_workers, np.int64)
        # span-touch planes of the worker's OPEN depth-1 span: per-cell
        # word interval [span_lo, span_hi); untouched cells hold
        # (I64_MAX, I64_MIN).  Allocated on the first span write.
        self.span_lo: Optional[torch.Tensor] = None
        self.span_hi: Optional[torch.Tensor] = None
        # race-detection vector-clock planes (detect_races runs only): cell
        # (u, p) of ``race_w`` is worker u's epoch at its last recorded
        # write of page p, ``race_r`` the read twin; 0 means never (epochs
        # start at 1).  Both live in one (2, W, cap) int64 tensor, so a
        # check of both is one gather.  Allocated on first use
        # (``ensure_race``); windows only grow and eviction leaves the
        # planes alone, so a recorded access is never dropped.
        self._race: Optional[torch.Tensor] = None
        # host per-row running max of every epoch recorded in each plane
        # (cells only grow, so it is the plane's row max): the screens
        self.race_maxw: Optional[np.ndarray] = None
        self.race_maxr: Optional[np.ndarray] = None
        # conservative per-row bounding interval of possibly-dirty pages
        # (absolute pages; empty when lo >= hi), reset on flush
        self.dirty_lo = np.full(n_workers, _I64_MAX, np.int64)
        self.dirty_hi = np.full(n_workers, _I64_MIN, np.int64)
        self.maybe_dirty = False
        self._cov_stale = True
        self._sorted_bases: Optional[np.ndarray] = None
        self._sorted_ends: Optional[np.ndarray] = None
        # 'plain' | 'kernels' | 'fused' (see config.BACKENDS): 'plain'
        # reduces the boolean planes with torch ops; the other two run the
        # CUDA kernels, which read the bool planes as they lie.
        # Integer-exact on every tier.
        self.backend = backend
        # the runtime's stats dict (fused_dispatches accounting), the
        # cached int32 window geometry of the fused flush, on the host and
        # as a padded device tensor, and the sorted bounds of the
        # shared-interval sweep as a (2, n) int64 device tensor
        self.stats: Optional[dict] = None
        self._jit_geom = None
        self._jit_geom_t: Optional[torch.Tensor] = None
        self._cov_bounds_t: Optional[torch.Tensor] = None

    def _plane(self, cols: int, fill, dtype=torch.bool) -> torch.Tensor:
        return torch.full((self.W, cols), fill, dtype=dtype,
                          device=self.device)

    def ix(self, a) -> torch.Tensor:
        """Host index array -> int64 index tensor on the plane device."""
        return torch.tensor(np.asarray(a, np.int64), device=self.device)

    # ------------------------------------------------------------------
    # window management
    # ------------------------------------------------------------------

    def _grown(self, plane: torch.Tensor, new_cap: int, fill):
        out = self._plane(new_cap, fill, plane.dtype)
        out[:, :self.cap] = plane
        return out

    def _grow_cap(self, need: int):
        new_cap = max(need, 2 * self.cap)
        self.valid = self._grown(self.valid, new_cap, False)
        self.dirty = self._grown(self.dirty, new_cap, False)
        if self.wprot is not None:
            self.wprot = self._grown(self.wprot, new_cap, True)
        if self.touch is not None:
            self.touch = self._grown(self.touch, new_cap, 0)
            self.incache = self._grown(self.incache, new_cap, False)
        if self.span_lo is not None:
            self.span_lo = self._grown(self.span_lo, new_cap, _I64_MAX)
            self.span_hi = self._grown(self.span_hi, new_cap, _I64_MIN)
        if self._race is not None:
            race = torch.zeros((2, self.W, new_cap), dtype=torch.int64,
                               device=self.device)
            race[:, :, :self.cap] = self._race
            self._race = race
        self.cap = new_cap

    def ensure_span(self):
        """Allocate the span-touch planes on first use."""
        if self.span_lo is None:
            self.span_lo = self._plane(self.cap, _I64_MAX, torch.int64)
            self.span_hi = self._plane(self.cap, _I64_MIN, torch.int64)

    @property
    def race_w(self) -> Optional[torch.Tensor]:
        return None if self._race is None else self._race[0]

    @property
    def race_r(self) -> Optional[torch.Tensor]:
        return None if self._race is None else self._race[1]

    def ensure_race(self):
        """Allocate the race vector-clock planes on first use."""
        if self._race is None:
            self._race = torch.zeros((2, self.W, self.cap),
                                     dtype=torch.int64, device=self.device)
            self.race_maxw = np.zeros(self.W, np.int64)
            self.race_maxr = np.zeros(self.W, np.int64)

    def ensure(self, w: int, lo: int, hi: int):
        """Grow row w's window to cover absolute pages [lo, hi)."""
        b = self.base[w]
        if b < 0:
            if hi - lo > self.cap:
                self._grow_cap(hi - lo)
            self.base[w] = lo
            self.length[w] = hi - lo
            self._cov_stale = True
            return
        changed = False
        if lo < b:
            pad = int(b - lo)
            n = int(self.length[w])
            if n + pad > self.cap:
                self._grow_cap(n + pad)
            for plane, init in ((self.valid, False), (self.dirty, False),
                                (self.wprot, True), (self.touch, 0),
                                (self.incache, False),
                                (self.span_lo, _I64_MAX),
                                (self.span_hi, _I64_MIN)):
                if plane is None:
                    continue
                row = plane[w]
                row[pad:pad + n] = row[:n].clone()
                row[:pad] = init
            if self._race is not None:
                rows = self._race[:, w]
                rows[:, pad:pad + n] = rows[:, :n].clone()
                rows[:, :pad] = 0
            self.base[w] = lo
            self.length[w] = n + pad
            self.shift[w] += pad
            b = lo
            changed = True
        if hi > b + self.length[w]:
            n = int(hi - b)
            if n > self.cap:
                self._grow_cap(n)
            self.length[w] = n
            changed = True
        if changed:
            self._cov_stale = True

    def sl(self, w: int, lo: int, hi: int) -> slice:
        b = int(self.base[w])
        return slice(lo - b, hi - b)

    def ensure_rows(self, lo: np.ndarray, hi: np.ndarray,
                    rows: np.ndarray):
        """Vectorized ``ensure`` over ``rows``; loops only over rows that
        actually need to grow (none in the steady state)."""
        base = self.base[rows]
        need = (base < 0) | (lo < base) | (hi > base + self.length[rows])
        for i in np.nonzero(need)[0]:
            self.ensure(int(rows[i]), int(lo[i]), int(hi[i]))

    # ------------------------------------------------------------------
    # cross-worker vector primitives
    # ------------------------------------------------------------------

    def range_cols(self, lo: np.ndarray, hi: np.ndarray,
                   rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row column-index matrix for the absolute page intervals
        [lo[i], hi[i]) of rows[i] (windows must cover them).  Returns
        host (cols (R, Lmax), mask (R, Lmax))."""
        L = hi - lo
        j = np.arange(int(L.max()) if L.size else 0)
        cols = (lo - self.base[rows])[:, None] + j[None, :]
        return cols, j[None, :] < L[:, None]

    def count_range(self, plane: torch.Tensor, lo: np.ndarray,
                    hi: np.ndarray,
                    rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-row counts of True cells of ``plane`` inside [lo[i], hi[i]),
        out-of-window cells reading False (windows need not cover the
        intervals).  ``rows`` restricts the count to a row subset."""
        rows = np.arange(self.W) if rows is None else rows
        if plane.shape[1] == 0 or rows.size == 0:
            return np.zeros(rows.size, np.int64)
        L = hi - lo
        Lmax = int(L.max())
        base = self.base[rows]
        length = self.length[rows]
        if not use_dense(rows.size, Lmax):
            # wide intervals: rows sharing a clipped window span sum one
            # 2D slice together, with no (R, Lmax) index matrices
            livem = base >= 0
            c0 = np.where(livem, np.maximum(lo - base, 0), 0)
            c1 = np.maximum(np.where(livem, np.minimum(hi - base, length),
                                     0), c0)
            out = np.zeros(rows.size, np.int64)
            uk, inv = np.unique(np.stack([c0, c1], axis=1), axis=0,
                                return_inverse=True)
            inv = inv.reshape(-1)
            for g in range(uk.shape[0]):
                a, b = int(uk[g, 0]), int(uk[g, 1])
                if b > a:
                    sel = np.nonzero(inv == g)[0]
                    out[sel] = plane[self.row_block(rows[sel]),
                                     a:b].sum(dim=1).cpu().numpy()
            return out
        j = np.arange(Lmax)
        cols = (lo - base)[:, None] + j[None, :]
        m = ((j[None, :] < L[:, None]) & (cols >= 0)
             & (cols < length[:, None]) & (base >= 0)[:, None])
        sub = plane[self.ix(rows)[:, None], self.ix(np.where(m, cols, 0))]
        sub &= torch.as_tensor(m, device=self.device)
        return sub.sum(dim=1).cpu().numpy()

    # ------------------------------------------------------------------
    # dirty bounding intervals
    # ------------------------------------------------------------------

    def note_dirty(self, rows, lo, hi):
        """Widen the dirty bounding interval of ``rows`` to cover absolute
        pages [lo, hi) (scalars or aligned arrays)."""
        self.dirty_lo[rows] = np.minimum(self.dirty_lo[rows], lo)
        self.dirty_hi[rows] = np.maximum(self.dirty_hi[rows], hi)

    def clear_dirty_bounds(self, rows=None):
        """Reset dirty bounds after a flush (``rows=None`` resets all)."""
        if rows is None:
            self.dirty_lo[:] = _I64_MAX
            self.dirty_hi[:] = _I64_MIN
        else:
            self.dirty_lo[rows] = _I64_MAX
            self.dirty_hi[rows] = _I64_MIN

    # ------------------------------------------------------------------
    # span-touch planes (consistency regions)
    # ------------------------------------------------------------------

    def span_note(self, w: int, p_lo: int, p_hi: int, wlo, whi):
        """Merge one span write's per-page word intervals into row w's
        span planes: cell p becomes (min, max) of itself and
        [wlo[p-p_lo], whi[p-p_lo]).  ``wlo``/``whi`` are scalars or
        aligned host arrays; the window must cover [p_lo, p_hi)."""
        self.ensure_span()
        s = self.sl(w, p_lo, p_hi)
        if np.ndim(wlo) == 0 and np.ndim(whi) == 0:
            self.span_lo[w, s].clamp_(max=int(wlo))
            self.span_hi[w, s].clamp_(min=int(whi))
            return
        lo_t = self.ix(np.broadcast_to(wlo, (p_hi - p_lo,)))
        hi_t = self.ix(np.broadcast_to(whi, (p_hi - p_lo,)))
        self.span_lo[w, s] = torch.minimum(self.span_lo[w, s], lo_t)
        self.span_hi[w, s] = torch.maximum(self.span_hi[w, s], hi_t)

    def span_harvest(self, w: int, p_lo: int, p_hi: int):
        """Collect and reset row w's span-touched cells inside absolute
        pages [p_lo, p_hi): host (pages, los, his), pages ascending — the
        release-publish payload.  Touched cells return to the untouched
        sentinel."""
        z = np.zeros(0, np.int64)
        if self.span_lo is None:
            return z, z, z
        b = int(self.base[w])
        s = self.sl(w, p_lo, p_hi)
        touched = torch.nonzero(self.span_hi[w, s] != _I64_MIN).flatten()
        if touched.numel() == 0:
            return z, z, z
        cols = touched + s.start
        vals = torch.stack([cols, self.span_lo[w, cols],
                            self.span_hi[w, cols]]).cpu().numpy()
        self.span_lo[w, cols] = _I64_MAX
        self.span_hi[w, cols] = _I64_MIN
        return vals[0] + b, vals[1].copy(), vals[2].copy()

    # ------------------------------------------------------------------
    # race vector-clock planes (detect_races mode)
    # ------------------------------------------------------------------

    def _race_max(self, is_write: bool) -> np.ndarray:
        return self.race_maxw if is_write else self.race_maxr

    def race_note(self, w: int, p_lo: int, p_hi: int, epoch: int,
                  is_write: bool):
        """Record worker w's access to absolute pages [p_lo, p_hi) at its
        current ``epoch`` (epochs are monotone per worker, so the store
        is a max).  The window must cover the range."""
        self.ensure_race()
        self._race[0 if is_write else 1, w, self.sl(w, p_lo, p_hi)] = epoch
        mx = self._race_max(is_write)
        mx[w] = max(int(mx[w]), int(epoch))

    def race_note_rows(self, rows: np.ndarray, p_lo: np.ndarray,
                       p_hi: np.ndarray, epochs: np.ndarray,
                       is_write: bool):
        """``race_note`` over ``rows``: row rows[i]'s access to absolute
        pages [p_lo[i], p_hi[i]) at epochs[rows[i]] (``race_note_cells``
        stores them)."""
        rows = np.asarray(rows, np.int64)
        self.race_note_cells(np.full(rows.size, 0 if is_write else 1),
                             rows, p_lo, p_hi, np.asarray(epochs)[rows])

    def race_note_cells(self, planes: np.ndarray, rows: np.ndarray,
                        p_lo: np.ndarray, p_hi: np.ndarray,
                        vals: np.ndarray):
        """Record n accesses: access i stores vals[i] over absolute pages
        [p_lo[i], p_hi[i]) of row rows[i] of plane planes[i] (0 the write
        plane, 1 the read plane).  Narrow ranges go as one upload of
        their flat cell index and one scatter; wide ones (``use_dense``
        false) as one slice store per (plane, column span) shared by
        their rows, with no per-cell index.  Windows must cover the
        ranges; accesses that store one cell store the same value (one
        worker's epoch)."""
        self.ensure_race()
        planes, rows = np.asarray(planes, np.int64), np.asarray(rows,
                                                               np.int64)
        if rows.size == 0:
            return
        vals = np.asarray(vals, np.int64)
        L = np.asarray(p_hi, np.int64) - p_lo
        c0 = np.asarray(p_lo, np.int64) - self.base[rows]
        if use_dense(rows.size, int(L.max())):
            ix = np.repeat(np.arange(rows.size), L)
            cols = c0[ix] + (np.arange(ix.size)
                             - np.repeat(np.cumsum(L) - L, L))
            cells = self.ix(np.stack([planes[ix], rows[ix], cols,
                                      vals[ix]]))
            self._race[cells[0], cells[1], cells[2]] = cells[3]
        else:
            uk, inv = np.unique(np.stack([planes, c0, c0 + L], axis=1),
                                axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            for g in range(uk.shape[0]):
                sel = np.nonzero(inv == g)[0]
                k, a, b = (int(x) for x in uk[g])
                self._race[k][self.row_block(rows[sel]), a:b] = self.ix(
                    vals[sel])[:, None]
        for k, mx in ((0, self.race_maxw), (1, self.race_maxr)):
            m = planes == k
            np.maximum.at(mx, rows[m], vals[m])

    def race_hits(self, p_lo: int, p_hi: int, vcw: np.ndarray,
                  is_write: bool) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, pages) of write (or read) epochs recorded over absolute
        pages [p_lo, p_hi) that are NOT ordered under the view ``vcw``,
        row-major: the scalar check, ``race_hits_many`` with one check."""
        (_, u, p), = self.race_hits_many(
            np.array([p_lo], np.int64), np.array([p_hi], np.int64),
            np.asarray(vcw, np.int64)[None, :], (is_write,))
        return u, p

    def race_hits_many(self, p_lo: np.ndarray, p_hi: np.ndarray,
                       views: np.ndarray, planes=(True,)):
        """Batched race check: check i is absolute pages [p_lo[i],
        p_hi[i]) under the vector-clock view views[i] (an (n, W) host
        array), against the write plane (True in ``planes``) and/or the
        read plane (False).  Returns, per entry of ``planes``, host
        (check, row, page) of every recorded epoch that the view does not
        order, ordered by check, row, page.

        The screen runs on the host: a row whose window misses the range
        (out-of-window cells read 0, never) or whose recorded maximum the
        view already covers holds no firing cell, and only the cells of
        the remaining (check, row) pairs go to the card: one upload of
        their (plane, row, column, view) index, one gather of both
        planes, one copy back of the hits (a check wider than
        ``RACE_CELLS`` cells takes one such round trip per chunk)."""
        z = np.zeros(0, np.int64)
        out = [(z, z, z) for _ in planes]
        if self._race is None or len(p_lo) == 0:
            return out
        p_lo = np.asarray(p_lo, np.int64)
        p_hi = np.asarray(p_hi, np.int64)
        live = self.base >= 0
        ov_lo = np.maximum(p_lo[:, None], self.base[None, :])
        ov_hi = np.minimum(p_hi[:, None], (self.base + self.length)[None, :])
        parts = []
        for k, is_write in enumerate(planes):
            cand = ((self._race_max(is_write)[None, :] > views)
                    & (ov_hi > ov_lo) & live[None, :])
            ci, cu = np.nonzero(cand)
            parts.append((k, ci, cu, ov_lo[ci, cu], ov_hi[ci, cu],
                          views[ci, cu]))
        n_cells = sum(int((hi - lo).sum()) for _, _, _, lo, hi, _ in parts)
        if n_cells == 0:
            return out
        # (entry, check, row, page, view) of every candidate cell
        cells = []
        for k, ci, cu, lo, hi, thr in parts:
            L = hi - lo
            ix = np.repeat(np.arange(ci.size), L)
            pages = lo[ix] + (np.arange(ix.size)
                              - np.repeat(np.cumsum(L) - L, L))
            cells.append(np.stack([np.full(ix.size, k), ci[ix], cu[ix],
                                   pages, thr[ix]]))
        cells = np.concatenate(cells, axis=1)
        pid = np.asarray([0 if w else 1 for w in planes], np.int64)[cells[0]]
        cols = cells[3] - self.base[cells[2]]
        hit = np.zeros(cells.shape[1], bool)
        for a in range(0, cells.shape[1], self.RACE_CELLS):
            b = a + self.RACE_CELLS
            t = self.ix(np.stack([pid[a:b], cells[2, a:b], cols[a:b],
                                  cells[4, a:b]]))
            hit[a:b] = (self._race[t[0], t[1], t[2]] > t[3]).cpu().numpy()
        for k in range(len(planes)):
            m = hit & (cells[0] == k)
            out[k] = (cells[1, m], cells[2, m], cells[3, m])
        return out

    # ------------------------------------------------------------------
    # row access
    # ------------------------------------------------------------------

    def row_block(self, rows: np.ndarray):
        """Row indexer for (rows x column-slice) plane access: a basic
        slice (a view; in-place updates) when ``rows`` is an ascending
        contiguous run, else an index tensor.  Contiguity is proven (unit
        steps), never inferred from size or bounds."""
        if rows.size > 1:
            if bool((np.diff(rows) == 1).all()):
                return slice(int(rows[0]), int(rows[-1]) + 1)
        elif rows.size == 1:
            return slice(int(rows[0]), int(rows[0]) + 1)
        return self.ix(rows)

    def cells(self, plane: torch.Tensor, rows: np.ndarray,
              cols: np.ndarray) -> np.ndarray:
        """Host copy of ``plane`` at host (rows, cols): rows (R,) against a
        column matrix (R, n) gathers an (R, n) block, one sync."""
        return plane[self.ix(rows)[:, None], self.ix(cols)].cpu().numpy()

    # ------------------------------------------------------------------
    # batched eviction primitives (segment LRU over touch-run spans)
    # ------------------------------------------------------------------

    def run_live(self, rows: np.ndarray, start: int, length: int,
                 run_ticks: np.ndarray) -> torch.Tensor:
        """(R, length) device liveness mask of one LRU touch run per row:
        a cell is live iff its touch tick still equals the run's tick
        ``run_ticks[i]`` (ticks are one per run and globally monotone, so
        a re-touch by a later run exceeds it) and it still occupies a
        cache slot.  All rows' runs share columns [start, start+length)."""
        s = slice(start, start + length)
        rb = self.row_block(rows)
        return ((self.touch[rb, s] == self.ix(run_ticks)[:, None])
                & self.incache[rb, s])

    def lru_take(self, live: torch.Tensor, k: np.ndarray,
                 tot: Optional[np.ndarray] = None) -> torch.Tensor:
        """Segment-LRU selection: per row, the first (oldest) k[i] live
        cells of the run, as a device mask.  Fully-live runs (``tot`` ==
        run length) reduce to a columnar cutoff; otherwise the kernel
        tiers run ``take_first_k`` on the bool runs as they lie, and
        'plain' takes a boolean prefix count.  The mask never leaves the
        device."""
        k = np.asarray(k, np.int64)
        L = live.shape[1]
        if tot is not None and bool((tot == L).all()):
            return (torch.arange(L, device=self.device)[None, :]
                    < self.ix(k)[:, None])
        if self.backend != "plain":
            # int32 ranks, as the kernel takes them (a rank past the run
            # length keeps the whole run either way)
            k32 = np.clip(k, -_I32_MAX - 1, _I32_MAX).astype(np.int32)
            take = _ps.take_first_k(live, torch.from_numpy(k32).to(
                self.device))
            self._note_fused()
            return take
        return live & (torch.cumsum(live, dim=1) <= self.ix(k)[:, None])

    def take_upto_row(self, live: torch.Tensor,
                      k: int) -> Tuple[np.ndarray, int]:
        """Rank-select over ONE run's device live mask (the refetch replay's
        victim scan): the host columns of the first k live cells and the
        scan cut, the index just past the k-th live cell.  The caller
        guarantees the run holds more than k live cells.  The kernel tiers
        read the bool run as it lies, with the rank by value, and bring
        back [cut, count, columns] in one copy (``take_run``): 'fused'
        computes both in one ``take_and_cut`` launch; 'kernels' runs
        ``take_first_k`` for the columns and the ``kth_set_index`` rank
        query for the cut (the reference's pallas tier reads the cut off
        the mask on the host instead; with more than k live cells the two
        agree); 'plain' takes a prefix count."""
        if self.backend == "plain":
            cs = torch.cumsum(live, dim=0)
            cut = int(torch.argmax((cs >= k).to(torch.int8)))
            return host(torch.nonzero(live & (cs <= k)).flatten()), cut + 1
        fused = self.backend == "fused"
        cut, cols = _ps.read_take_run(_ps.take_run(live, k, fused))
        if fused:
            self._note_fused()
        return cols, cut + 1

    def evict_rows(self, rows: np.ndarray, start: int, length: int,
                   take: Optional[torch.Tensor], *,
                   set_wprot: bool) -> np.ndarray:
        """Batched eviction of the ``take`` cells (an (R, length) device
        mask over columns [start, start+length) of ``rows``; None takes
        the whole span): dirty victims clear and re-arm write protection
        (when ``set_wprot``), then valid and the cache slot drop.  Returns
        host per-row dirty-victim counts (the runtime's writeback charge):
        ``popcount_rows`` on the kernel tiers, which reads the victims in
        place (without a take, a view of the dirty plane), a row sum on
        'plain'.  Plane updates only; charging stays in the runtime."""
        s = slice(start, start + length)
        rb = self.row_block(rows)
        dm = self.dirty[rb, s]
        if take is not None:
            dm = dm & take
        if self.backend != "plain":
            db = _ps.popcount_rows(dm)
            self._note_fused()
        else:
            db = dm.sum(dim=1)
        db = db.cpu().numpy()
        if db.any():
            # wprot first: without a take, dm is a view of the dirty cells
            if set_wprot and self.wprot is not None:
                self.wprot[rb, s] = self.wprot[rb, s] | dm
            self.dirty[rb, s] = self.dirty[rb, s] & ~dm
        if take is None:
            self.valid[rb, s] = False
            self.incache[rb, s] = False
        else:
            keep = ~take
            self.valid[rb, s] = self.valid[rb, s] & keep
            self.incache[rb, s] = self.incache[rb, s] & keep
        return db

    def overlap_rows(self, lo: int, hi: int,
                     exclude: Optional[int] = None) -> np.ndarray:
        """Workers whose window intersects absolute pages [lo, hi)."""
        m = ((self.base >= 0) & (self.base < hi)
             & (self.base + self.length > lo))
        if exclude is not None:
            m[exclude] = False
        return np.nonzero(m)[0]

    def gather_valid(self, rows: np.ndarray,
                     pages: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host (len(rows), len(pages)) validity matrix plus the column
        matrix (for scattering back).  Out-of-window cells read False."""
        cols = pages[None, :] - self.base[rows][:, None]
        inr = (cols >= 0) & (cols < self.length[rows][:, None])
        sub = self.valid[self.ix(rows)[:, None],
                         self.ix(np.where(inr, cols, 0))]
        return sub.cpu().numpy() & inr, cols

    def clear_valid_cells(self, rows: np.ndarray, cols: np.ndarray,
                          hit: np.ndarray) -> np.ndarray:
        """Clear valid at the True cells of the host mask ``hit`` (aligned
        with ``cols``); returns per-row cleared counts."""
        ri, ci = np.nonzero(hit)
        if ri.size:
            self.valid[self.ix(rows[ri]), self.ix(cols[ri, ci])] = False
        return hit.sum(axis=1)

    # ------------------------------------------------------------------
    # flush reductions
    # ------------------------------------------------------------------

    def _refresh_bounds(self):
        if self._cov_stale:
            live = self.base >= 0
            self._sorted_bases = np.sort(self.base[live])
            self._sorted_ends = np.sort((self.base + self.length)[live])
            self._jit_geom = None          # window geometry changed
            self._jit_geom_t = None
            self._cov_bounds_t = None
            self._cov_stale = False

    def jit_geometry(self):
        """Host (base, sorted_bases, sorted_ends) as int32 — the fused
        flush's window-geometry operands, cached until a window changes."""
        self._refresh_bounds()
        if self._jit_geom is None:
            self._jit_geom = (self.base.astype(np.int32),
                              self._sorted_bases.astype(np.int32),
                              self._sorted_ends.astype(np.int32))
        return self._jit_geom

    def jit_geometry_tensor(self) -> torch.Tensor:
        """``jit_geometry`` as one (3, W) int32 tensor on the plane device
        (base, then the sorted bounds padded with INT32_MAX), copied to
        the device once per window change rather than once per flush."""
        b32, sb, se = self.jit_geometry()
        if self._jit_geom_t is None:
            geom = np.full((3, self.W), _I32_MAX, np.int32)
            geom[0] = b32
            geom[1, :sb.size] = sb
            geom[2, :se.size] = se
            self._jit_geom_t = torch.as_tensor(geom, device=self.device)
        return self._jit_geom_t

    def _note_fused(self):
        if self.backend == "fused" and self.stats is not None:
            self.stats["fused_dispatches"] += 1

    def coverage_bounds(self) -> torch.Tensor:
        """The sorted live window starts and ends as one (2, n) int64
        tensor on the plane device, the shared-interval sweep's operand
        (int64 keeps page ids past INT32_MAX exact), copied to the device
        once per window change rather than once per flush."""
        self._refresh_bounds()
        if self._cov_bounds_t is None:
            self._cov_bounds_t = torch.as_tensor(
                np.stack([self._sorted_bases, self._sorted_ends]),
                device=self.device)
        return self._cov_bounds_t

    def shared_intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Absolute page intervals covered by >= 2 worker windows, as host
        (starts, ends) — a sweep over the 2W sorted window bounds, from
        their cached device tensor: ``coverage_multi`` merges them and
        flags the multiply-covered points on the kernel tiers, its plain
        version (a stable sort and a cumsum) on 'plain'; the host reads
        both back in one copy and finds the interval edges."""
        self._refresh_bounds()
        n = self._sorted_bases.size
        if n < 2:
            z = np.zeros(0, np.int64)
            return z, z
        if self.backend == "plain":
            buf = _ps._coverage_multi_plain(self.coverage_bounds())
        else:
            buf = _ps.coverage_multi(self.coverage_bounds())
            self._note_fused()
        buf = buf.cpu().numpy()
        pts, multi = buf[:2 * n], buf[2 * n:] != 0
        edge = np.diff(np.concatenate([[False], multi]).astype(np.int8))
        starts = pts[np.nonzero(edge == 1)[0]]
        ends = pts[np.nonzero(edge == -1)[0]]
        if multi[-1]:
            ends = np.concatenate([ends, pts[-1:]])
        keep = ends > starts
        return starts[keep], ends[keep]

    def dirty_counts(self) -> np.ndarray:
        """Host (W,) per-row dirty-page counts — the barrier-flush
        popcount: ``popcount_rows`` over the bool dirty plane on the kernel
        tiers, a bool row sum on 'plain'.  Cells outside a row's window
        are always False, so the whole-plane reduction is exact."""
        if self.cap == 0:
            return np.zeros(self.W, np.int64)
        if self.backend == "plain":
            return self.dirty.sum(dim=1).cpu().numpy()
        counts = _ps.popcount_rows(self.dirty)
        self._note_fused()
        return counts.cpu().numpy()

    def row_dirty_cols(self, w: int) -> np.ndarray:
        n = int(self.length[w])
        return torch.nonzero(self.dirty[w, :n]).flatten().cpu().numpy()

    # ------------------------------------------------------------------
    # state carried across from the reference (see core.carry)
    # ------------------------------------------------------------------

    def state_arrays(self, rows=None) -> Tuple[dict, dict]:
        """Full plane state as host (arrays, meta), in the reference's
        ``RegionDirectory.state_arrays`` format.

        Every array is worker-major (first dim ``W``), so ``rows`` (a
        slice) restricts the payload to a shard's worker slice: the
        planes are sliced on their device before the copy to the host,
        so only those rows come back.  ``meta`` still records the full
        ``W``."""
        sl = slice(None) if rows is None else rows
        arrays = {"base": self.base[sl].copy(),
                  "length": self.length[sl].copy(),
                  "shift": self.shift[sl].copy(),
                  "valid": self.valid[sl].cpu().numpy().copy(),
                  "dirty": self.dirty[sl].cpu().numpy().copy(),
                  "dirty_lo": self.dirty_lo[sl].copy(),
                  "dirty_hi": self.dirty_hi[sl].copy()}
        # the race planes are the halves of one (2, W, cap) tensor:
        # race_w and race_r slice dim 1 of it
        for name in ("wprot", "touch", "incache", "span_lo", "span_hi",
                     "race_w", "race_r"):
            plane = getattr(self, name)
            if plane is not None:
                arrays[name] = plane[sl].cpu().numpy().copy()
        if self._race is not None:
            arrays["race_maxw"] = self.race_maxw[sl].copy()
            arrays["race_maxr"] = self.race_maxr[sl].copy()
        meta = {"W": self.W, "region": self.region,
                "page_lo": self.page_lo, "page_hi": self.page_hi,
                "cap": self.cap, "maybe_dirty": bool(self.maybe_dirty),
                "track_wprot": self.wprot is not None,
                "track_touch": self.touch is not None,
                "has_span": self.span_lo is not None,
                "has_race": self._race is not None,
                "backend": self.backend}
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, *, backend: str,
                   device) -> "RegionDirectory":
        """Rebuild a directory from ``state_arrays`` output (this
        package's or the reference's)."""
        d = cls(meta["W"], meta["region"], meta["page_lo"],
                meta["page_hi"], track_wprot=meta["track_wprot"],
                track_touch=meta["track_touch"], backend=backend,
                device=device)
        d.cap = int(meta["cap"])
        d.base = np.asarray(arrays["base"], np.int64).copy()
        d.length = np.asarray(arrays["length"], np.int64).copy()
        d.shift = np.asarray(arrays["shift"], np.int64).copy()
        d.dirty_lo = np.asarray(arrays["dirty_lo"], np.int64).copy()
        d.dirty_hi = np.asarray(arrays["dirty_hi"], np.int64).copy()

        def plane(name, dtype):
            return torch.as_tensor(np.asarray(arrays[name]), dtype=dtype,
                                   device=d.device).clone()

        d.valid = plane("valid", torch.bool)
        d.dirty = plane("dirty", torch.bool)
        if meta["track_wprot"]:
            d.wprot = plane("wprot", torch.bool)
        if meta["track_touch"]:
            d.touch = plane("touch", torch.int64)
            d.incache = plane("incache", torch.bool)
        if meta["has_span"]:
            d.span_lo = plane("span_lo", torch.int64)
            d.span_hi = plane("span_hi", torch.int64)
        if meta.get("has_race"):
            d._race = torch.stack([plane("race_w", torch.int64),
                                   plane("race_r", torch.int64)])
            d.race_maxw = np.asarray(arrays["race_maxw"], np.int64).copy()
            d.race_maxr = np.asarray(arrays["race_maxr"], np.int64).copy()
        d.maybe_dirty = bool(meta["maybe_dirty"])
        d._cov_stale = True
        return d


class IntervalLog:
    """Flat, version-segmented (page, lo, hi) notice log for one lock.

    ``append_version`` records one release's notices (``append_versions``
    several at once); ``pending`` returns
    the per-page coalesced (min lo, max hi) intervals of every version in
    ``[v_from, v_to)``, pages ascending (the replay order).  Notices are
    host metadata read only by host-side charging, so the log is numpy.
    """

    __slots__ = ("_p", "_lo", "_hi", "_n", "voff")

    def __init__(self):
        self._p = np.zeros(8, np.int64)
        self._lo = np.zeros(8, np.int64)
        self._hi = np.zeros(8, np.int64)
        self._n = 0
        self.voff = [0]

    def _reserve(self, k: int):
        need = self._n + k
        if need > self._p.size:
            cap = max(need, 2 * self._p.size)
            for name in ("_p", "_lo", "_hi"):
                arr = getattr(self, name)
                new = np.zeros(cap, np.int64)
                new[:self._n] = arr[:self._n]
                setattr(self, name, new)

    def append_version(self, pages, los, his):
        k = len(pages)
        self._reserve(k)
        n = self._n
        self._p[n:n + k] = pages
        self._lo[n:n + k] = los
        self._hi[n:n + k] = his
        self._n = n + k
        self.voff.append(self._n)

    def append_versions(self, pages, los, his, counts):
        """Append several versions in one copy: version i owns the next
        ``counts[i]`` entries of the flat (pages, los, his) arrays
        (``span_all``'s grant group, whose members all publish the same
        payload, tiled by the caller)."""
        k = len(pages)
        assert int(np.sum(counts)) == k, (counts, k)
        self._reserve(k)
        n = self._n
        self._p[n:n + k] = pages
        self._lo[n:n + k] = los
        self._hi[n:n + k] = his
        self._n = n + k
        self.voff.extend((n + np.cumsum(counts, dtype=np.int64)).tolist())

    def payload_matches(self, v_from: int, v_to: int, pages, los,
                        his) -> bool:
        """True iff every version in [v_from, v_to) carries exactly this
        payload (the same pages, los and his, in order): the grant
        group's backlog check.  The caller already knows that each
        version holds ``len(pages)`` entries."""
        a, b = self.voff[v_from], self.voff[v_to]
        k = v_to - v_from
        n = len(pages)
        if b - a != k * n:
            return False
        return (bool((self._p[a:b].reshape(k, n) == pages).all())
                and bool((self._lo[a:b].reshape(k, n) == los).all())
                and bool((self._hi[a:b].reshape(k, n) == his).all()))

    def page_bounds(self, v_from: int, v_to: int):
        """Bounding (lo, hi) page interval of every notice in versions
        [v_from, v_to), or None for an empty slice: the footprint the
        flush-hoist screen of ``span_all`` tests."""
        a, b = self.voff[v_from], self.voff[v_to]
        if a == b:
            return None
        seg = self._p[a:b]
        return int(seg.min()), int(seg.max()) + 1

    def state_arrays(self) -> dict:
        """Live log contents plus the version offsets (the reference's
        snapshot format)."""
        n = self._n
        return {"p": self._p[:n].copy(), "lo": self._lo[:n].copy(),
                "hi": self._hi[:n].copy(),
                "voff": np.asarray(self.voff, np.int64)}

    @classmethod
    def from_state(cls, arrays: dict) -> "IntervalLog":
        log = cls()
        p = np.asarray(arrays["p"], np.int64)
        n = int(p.size)
        log._reserve(n)
        log._p[:n] = p
        log._lo[:n] = np.asarray(arrays["lo"], np.int64)
        log._hi[:n] = np.asarray(arrays["hi"], np.int64)
        log._n = n
        log.voff = [int(v) for v in np.asarray(arrays["voff"], np.int64)]
        return log

    def pending(self, v_from: int, v_to: int):
        """Coalesced (pages, lo_min, hi_max) over versions [v_from, v_to)."""
        a, b = self.voff[v_from], self.voff[v_to]
        if a == b:
            e = np.zeros(0, np.int64)
            return e, e, e
        u, inv = np.unique(self._p[a:b], return_inverse=True)
        lo_min = np.full(u.size, _I64_MAX, np.int64)
        hi_max = np.full(u.size, _I64_MIN, np.int64)
        np.minimum.at(lo_min, inv, self._lo[a:b])
        np.maximum.at(hi_max, inv, self._hi[a:b])
        return u, lo_min, hi_max
