"""Bitmask protocol-sweep kernels for the RegC sharing directory.

The directory's boolean page-state planes (one row per worker, see
``core.directory.RegionDirectory``) pack 32 pages per word: bit ``j`` of
word ``k`` in row ``w`` is directory column ``32*k + j`` of worker ``w``
(little-endian).  Packed words are stored as ``torch.int32`` and read as
unsigned by the kernels; the plain versions do their bit arithmetic in
int64 (torch's CPU build lacks shifts on uint32).

Hand-written CUDA kernels (``csrc/protocol_sweep.cu``, ``sm_90a``):

* ``pack_rows``      (W, C) bool plane -> (W, ceil(C/32)) packed words
  (the counterpart of the reference's host helper ``pack_mask_rows``;
  no path of the engine calls it, since every kernel below reads the
  bool planes itself);
* ``popcount_rows``  per-row counts of the nonzero cells of bool rows
  read in place (any row stride): the unfused barrier flush's writeback
  charge and the eviction engine's dirty-victim counts;
* ``coverage_multi`` the shared-interval sweep from a region's sorted
  window starts and ends (int64, cached on the card): the merged sweep
  points and where the running cover is >= 2, in one buffer;
* ``phase_step``     the fused barrier flush over R regions, read from
  their bool dirty planes as they lie: per-row popcount, coverage stab,
  and the shared-dirty candidate words (dirty & multi-covered & active
  row), in one launch (one more for each ``MAX_PHASE_STEP_REGIONS``
  regions past the first); ``read_phase_step`` brings its result to the
  host in one copy, or two when there are more than
  ``PHASE_STEP_PREFIX`` candidate words;
* ``take_first_k``   per-row rank-select over bool run planes read in
  place (any row stride): each row's first k[i] set cells as a bool
  mask (the segment-LRU victim mask of batched eviction);
* ``kth_set_index``  per-row rank query: the column of the k[i]-th set
  cell, -1 out of range (the refetch replay's victim-scan cut);
* ``take_and_cut``   both of the last two in one launch;
* ``take_run``       one run's victim scan in the form the host reads in
  one copy (``read_take_run``): [cut, count, columns of the taken
  cells], the rank by value; one ``take_and_cut`` launch, or
  ``take_first_k`` and ``kth_set_index`` into the same buffer.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current stream, adding
one to ``LAUNCHES[name]`` per launch and to ``CALLS[name]`` per call on
any device.  A tensor on the CPU takes the
kernel's plain PyTorch version (``_*_plain``) instead; a CUDA tensor gets
the kernel or an exception, never the plain version.  The plain versions
mirror the reference's numpy tier bit for bit and are what the tests and
``chip_smoke.py`` hold the kernels against.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import Kernels, check, on_card

_M32 = 0xFFFFFFFF
_I32_MAX = (1 << 31) - 1
# phase_step stages 2W int32 bounds in dynamic shared memory and opts in
# past the 48 KiB default: stay within Hopper's 227 KiB a block, less
# 1 KiB for its static shared memory (208 bytes) and the dynamic array's
# alignment
MAX_PHASE_STEP_W = (227 * 1024 - 1024) // 8
# regions one phase_step launch takes (kMaxRegions in the CUDA source);
# a flush with more takes one launch more for each this many
MAX_PHASE_STEP_REGIONS = 32
# candidate entries read back in the first copy with the counts (16 KiB);
# a flush with more copies the rest in a second
PHASE_STEP_PREFIX = 1024

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_KERNELS = Kernels("protocol_sweep.cu", {
    "pack_rows": (_P, _P, _L, _L, _L),
    "popcount_rows": (_P, _L, _L, _L, _P),
    "coverage_multi": (_P, _L, _P),
    "phase_step": (_P, _P, _P, _P, _L, _L, _L),
    "take_first_k": (_P, _L, _L, _L, _P, _L, _P, _P),
    "kth_set_index": (_P, _L, _L, _L, _P, _L, _P, _P),
    "take_and_cut": (_P, _L, _L, _L, _P, _L, _P, _P, _P),
})
# launch counters: one per kernel, bumped only where a kernel launches;
# CALLS counts each wrapper's calls on any device
LAUNCHES = _KERNELS.launches
CALLS = _KERNELS.calls
_launch = _KERNELS.launch
_called = _KERNELS.called
# the phase_step launches given a row mask (span_all's hoisted flush),
# also counted in LAUNCHES
ROWMASK_LAUNCHES = {"phase_step": 0}


def reset_launches():
    _KERNELS.reset()
    ROWMASK_LAUNCHES["phase_step"] = 0


def load():
    """Build the library if need be and bind its entries now, rather than
    at the first launch (a cluster shard does this at its init)."""
    _KERNELS.entry("phase_step")


# phase_step's two uint32 counters (candidate slots, finished blocks) for
# each (card, stream), zero between launches: the kernel's last block
# resets them, and the wrapper zeroes them when a launch is refused.
# Launches on one stream never overlap, so no two flushes share them.
_PHASE_WS = {}


def phase_step_ws(index: int) -> torch.Tensor:
    """The counters of the current stream of card ``index``."""
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    ws = _PHASE_WS.get(key)
    if ws is None:
        ws = _PHASE_WS[key] = torch.zeros(2, dtype=torch.int32,
                                          device=f"cuda:{index}")
    return ws


# ---------------------------------------------------------------------------
# plain versions (CPU tier and the kernels' on-card comparison)
# ---------------------------------------------------------------------------


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return words.to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> int32 bit patterns."""
    return torch.where(x > _I32_MAX, x - (1 << 32), x).to(torch.int32)


def _popcount_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Per-word SWAR popcount (the reference's ``_popcount_words``), in
    int64; the multiply is masked to 32 bits as uint32 wraps."""
    v = _u32(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _pack_rows_plain(plane: torch.Tensor) -> torch.Tensor:
    """(W, C) bool -> (W, ceil(C/32)) int32 words, bit j of word k =
    column 32k + j; zero padding past C."""
    W, C = plane.shape
    nw = -(-C // 32)
    cells = torch.zeros((W, nw * 32), dtype=torch.int64, device=plane.device)
    cells[:, :C] = plane
    shifts = torch.arange(32, dtype=torch.int64, device=plane.device)
    return _as_i32((cells.view(W, nw, 32) << shifts).sum(dim=-1))


def unpack_rows(bits: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Inverse of ``pack_rows``: (W, nw) int32 words -> (W, n_cols) bool."""
    W, nw = bits.shape
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    cells = (_u32(bits).unsqueeze(-1) >> shifts) & 1
    return cells.reshape(W, nw * 32)[:, :n_cols].bool()


def _popcount_rows_plain(bits: torch.Tensor) -> torch.Tensor:
    """Per-row set-bit counts of packed (W, nw) words: the chain to the
    reference's ``_popcount_rows_np``."""
    return _popcount_words_plain(bits).sum(dim=1)


def _popcount_rows_bool_plain(plane: torch.Tensor) -> torch.Tensor:
    """``popcount_rows``: per-row counts of the nonzero cells of bool
    rows (a byte of 2 or 0xff counts as one, as in the kernel)."""
    return (plane.view(torch.uint8) != 0).sum(dim=1)


def _coverage_multi_delta_plain(delta: torch.Tensor) -> torch.Tensor:
    """Running cover >= 2 over sorted +1/-1 bound deltas: the chain to
    the reference's ``coverage_multi(delta)``."""
    return torch.cumsum(delta.to(torch.int64), dim=0) >= 2


def _coverage_multi_plain(bounds: torch.Tensor) -> torch.Tensor:
    """``coverage_multi``: the bounds merged by a stable sort (starts
    first at equal values, the reference's ``np.argsort(kind="stable")``
    of the concatenated bounds), then the running cover of their deltas
    >= 2, as one int64 buffer [points, flags]."""
    n = bounds.shape[1]
    points, order = torch.sort(bounds.reshape(-1), stable=True)
    delta = torch.where(order < n, 1, -1)
    multi = _coverage_multi_delta_plain(delta)
    return torch.cat([points, multi.to(torch.int64)])


def _shared_words_plain(bits, base, active, sb, se):
    """One region's packed candidate words (W, nw) int32: the dirty
    ``bits`` of ``active`` rows that are covered by >= 2 live windows
    (page = ``base`` + column, stabbed in the sorted bounds ``sb``/``se``),
    as the reference's ``_phase_step_np`` computes them."""
    W, nw = bits.shape
    dev = bits.device
    col = (torch.arange(nw, dtype=torch.int64, device=dev)[:, None] * 32
           + torch.arange(32, dtype=torch.int64, device=dev)[None, :])
    lanes = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    page = base.to(torch.int64)[:, None, None] + col[None]
    flat = page.reshape(-1)
    cov = (torch.searchsorted(sb.to(torch.int64), flat, right=True)
           - torch.searchsorted(se.to(torch.int64), flat, right=True))
    multi = (cov >= 2).reshape(page.shape)
    mbits = torch.where(multi, lanes, zero).sum(dim=-1)          # (W, nw)
    return _as_i32(torch.where(active[:, None], _u32(bits) & mbits, zero))


def _phase_step_plain(planes, geoms, rowmask=None):
    """``phase_step``'s result, region by region: the packed dirty plane,
    its row counts and candidate words as the reference's
    ``_phase_step_np``, laid out as the kernel's ``out`` with the entries
    in key order."""
    R, W = len(planes), planes[0].shape[0]
    dev = planes[0].device
    counts, keys, words = [], [], []
    for r, (plane, geom) in enumerate(zip(planes, geoms)):
        bits = _pack_rows_plain(plane)
        c = _popcount_words_plain(bits).sum(dim=1)
        active = c > 0
        if rowmask is not None:
            active = active & rowmask[r]
        shared = _shared_words_plain(bits, geom[0], active, geom[1], geom[2])
        row, k = torch.nonzero(shared, as_tuple=True)
        counts.append(c)
        keys.append(((r * W + row) << 32) | k)
        words.append(_u32(shared[row, k]))
    n = sum(k.shape[0] for k in keys)
    size = R * W + 1 + 2 * W * sum((p.shape[1] + 31) // 32 for p in planes)
    out = torch.zeros(size, dtype=torch.int64, device=dev)
    out[:R * W] = torch.cat(counts)
    out[R * W] = n
    if n:
        out[R * W + 1:R * W + 1 + 2 * n] = torch.stack(
            [torch.cat(keys), torch.cat(words)], dim=1).reshape(-1)
    return out


def _take_first_k_plain(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's first k[i] set bits (the reference's ``_take_first_k_np``):
    word-prefix popcounts bound how many bits each word still needs, then
    32 shift steps keep bit j iff its rank in the word is below that
    need."""
    v = _u32(bits)
    pc = _popcount_words_plain(bits)
    excl = torch.cumsum(pc, dim=1) - pc
    need = torch.clamp(k.to(torch.int64)[:, None] - excl, 0, 32)
    out = torch.zeros_like(v)
    run = torch.zeros_like(v)
    for j in range(32):
        bit = (v >> j) & 1
        out |= (bit.bool() & (run < need)).to(torch.int64) << j
        run += bit
    return _as_i32(out)


def _kth_set_index_plain(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Column of each row's k[i]-th (1-based) set bit, -1 when k[i] <= 0 or
    the row has fewer set bits (the reference's ``_kth_set_index_np``)."""
    R = bits.shape[0]
    kk = k.to(torch.int64)
    v = _u32(bits)
    pc = _popcount_words_plain(bits)
    cum = torch.cumsum(pc, dim=1)
    total = cum[:, -1]
    # first word whose running count reaches k; argmax returns the first
    # maximum, as numpy's does (an all-False row gives 0, masked below)
    wi = torch.argmax((cum >= kk[:, None]).to(torch.int8), dim=1)
    rows = torch.arange(R, device=bits.device)
    need = kk - (cum[rows, wi] - pc[rows, wi])
    word = v[rows, wi]
    run = torch.zeros(R, dtype=torch.int64, device=bits.device)
    idx = torch.full((R,), -1, dtype=torch.int64, device=bits.device)
    for j in range(32):
        bit = (word >> j) & 1
        run += bit
        hit = (idx < 0) & (bit == 1) & (run == need)
        idx = torch.where(hit, 32 * wi + j, idx)
    return torch.where((kk >= 1) & (total >= kk), idx,
                       torch.full_like(idx, -1))


def _take_first_k_bool_plain(live: torch.Tensor,
                             k: torch.Tensor) -> torch.Tensor:
    """``take_first_k`` on bool rows: each row's first k[i] set cells."""
    return live & (torch.cumsum(live, dim=1) <= k.to(torch.int64)[:, None])


def _kth_set_index_bool_plain(live: torch.Tensor,
                              k: torch.Tensor) -> torch.Tensor:
    """``kth_set_index`` on bool rows: the column of the first prefix
    count that reaches k[i], -1 when k[i] <= 0 or the row has fewer set
    cells."""
    R, C = live.shape
    kk = k.to(torch.int64)
    if C == 0:
        return torch.full((R,), -1, dtype=torch.int64, device=live.device)
    cs = torch.cumsum(live, dim=1)
    col = torch.argmax((cs >= kk[:, None]).to(torch.int8), dim=1)
    return torch.where((kk >= 1) & (cs[:, -1] >= kk), col,
                       torch.full_like(col, -1))


def _take_run_plain(live: torch.Tensor, k: int) -> torch.Tensor:
    """``take_run``: [cut, count, columns of the first k set cells]."""
    kt = torch.tensor([k], dtype=torch.int64, device=live.device)
    cut = _kth_set_index_bool_plain(live[None], kt)
    cols = torch.nonzero(_take_first_k_bool_plain(live[None], kt)[0])
    count = torch.tensor([cols.shape[0]], dtype=torch.int64,
                         device=live.device)
    return torch.cat([cut, count, cols.flatten()])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def pack_rows(plane: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(W, C) bool -> packed (W, ceil(C/32)) int32 words.  ``out`` may be
    a wider (W, nw_out) int32 buffer; words past ceil(C/32) become 0."""
    CALLS["pack_rows"] += 1
    if not (plane.dtype is torch.bool and plane.dim() == 2
            and plane.is_contiguous()):
        check(plane, "plane", torch.bool, 2, plane.device)
    W, C = plane.shape
    nw = (C + 31) >> 5
    if out is None:
        out = torch.empty((W, nw), dtype=torch.int32, device=plane.device)
    elif not (out.dtype is torch.int32 and out.dim() == 2
              and out.is_contiguous() and out.device == plane.device
              and out.shape[0] == W and out.shape[1] >= nw):
        check(out, "out", torch.int32, 2, plane.device)
        raise ValueError(f"out shape {tuple(out.shape)} cannot hold "
                         f"({W}, {nw}) packed words")
    index = plane.get_device()
    if index < 0:
        on_card(plane)
        out.zero_()
        out[:, :nw] = _pack_rows_plain(plane)
        return out
    if W and out.shape[1]:
        _launch("pack_rows", index, plane.data_ptr(), out.data_ptr(), W, C,
                out.shape[1])
    return out


def popcount_rows(plane: torch.Tensor) -> torch.Tensor:
    """(R, C) bool rows -> (R,) int64 counts of their nonzero cells.
    ``plane`` may be a view with any row stride, each row's cells
    contiguous (a column window of a plane, every other row of one): the
    kernel reads it in place."""
    _called("popcount_rows")
    _check_rows(plane, "plane")
    dev = plane.device
    if not on_card(plane):
        return _popcount_rows_bool_plain(plane)
    R, C = plane.shape
    if R == 0 or C == 0:
        return torch.zeros(R, dtype=torch.int64, device=dev)
    counts = torch.empty(R, dtype=torch.int64, device=dev)
    _launch("popcount_rows", dev, plane.data_ptr(), plane.stride(0), R, C,
            counts.data_ptr())
    return counts


def coverage_multi(bounds: torch.Tensor) -> torch.Tensor:
    """A region's sorted live window bounds, a (2, n) int64 tensor (the
    starts, then the ends, each ascending) -> one int64 buffer of 4n: the
    2n bounds merged in the reference's stable order (at equal values
    every start before every end), then each merged point's flag, 1 where
    the running cover after it (starts minus ends so far) is >= 2.  The
    host reads both halves back in one copy."""
    _called("coverage_multi")
    dev = bounds.device
    check(bounds, "bounds", torch.int64, 2, dev)
    if bounds.shape[0] != 2:
        raise ValueError(f"bounds shape {tuple(bounds.shape)}: two rows "
                         "(starts, ends) expected")
    if not on_card(bounds):
        return _coverage_multi_plain(bounds)
    n = bounds.shape[1]
    out = torch.empty(4 * n, dtype=torch.int64, device=dev)
    if n:
        _launch("coverage_multi", dev, bounds.data_ptr(), n, out.data_ptr())
    return out


def phase_step(planes: Sequence[torch.Tensor],
               geoms: Sequence[torch.Tensor],
               rowmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused barrier flush over R regions, from their bool dirty
    planes as they lie: ``planes[r]`` (W, cap_r) contiguous ``torch.bool``
    (caps may differ; columns past cap_r count as zero), ``geoms[r]`` the
    region's (3, W) int32 window geometry (row bases, -1 for rows without
    a window, then the sorted live window starts and ends padded with
    INT32_MAX), and an optional (R, W) bool ``rowmask`` (None: every row).

    Returns one int64 tensor ``out``: the (R, W) per-row dirty counts,
    row-major, then n, then n entries (key, word): a candidate word, the
    packed dirty & >=2-covered bits of word k of row w of region r on an
    active row (masked in, count > 0), with key = (r*W + w) << 32 | k.
    The kernel writes the entries in no fixed order; ``read_phase_step``
    sorts them.  One launch for up to ``MAX_PHASE_STEP_REGIONS`` regions,
    one more for each as many again."""
    CALLS["phase_step"] += 1
    R = len(planes)
    if R == 0 or len(geoms) != R:
        raise ValueError(f"phase_step: {R} planes and {len(geoms)} "
                         "geometries; at least one region each")
    p0 = planes[0]
    index = p0.get_device()
    W = p0.shape[0] if p0.dim() == 2 else -1
    words = 0
    for t in planes:
        if not (t.dtype is torch.bool and t.dim() == 2 and t.shape[0] == W
                and t.is_contiguous() and t.get_device() == index):
            check(t, "plane", torch.bool, 2, p0.device)
            raise ValueError(f"plane shape {tuple(t.shape)}: every plane "
                             f"needs the first's {W} rows")
        words += (t.shape[1] + 31) >> 5
    for g in geoms:
        if not (g.dtype is torch.int32 and g.shape == (3, W)
                and g.is_contiguous() and g.get_device() == index):
            check(g, "geom", torch.int32, 2, p0.device)
            raise ValueError(f"geom shape {tuple(g.shape)} != {(3, W)}")
    if rowmask is not None:
        check(rowmask, "rowmask", torch.bool, 2, p0.device)
        if tuple(rowmask.shape) != (R, W):
            raise ValueError(f"rowmask shape {tuple(rowmask.shape)} != "
                             f"{(R, W)}")
    if index < 0:
        on_card(p0)
        return _phase_step_plain(planes, geoms, rowmask)
    if W > MAX_PHASE_STEP_W:
        raise ValueError(f"phase_step: W={W} exceeds the kernel's limits "
                         f"(W <= {MAX_PHASE_STEP_W})")
    # one entry at most for each word of each row
    capacity = W * words
    out = torch.empty(R * W + 1 + 2 * capacity, dtype=torch.int64,
                      device=p0.device)
    if W == 0:
        return out.zero_()
    ws = phase_step_ws(index)
    desc = (ctypes.c_longlong * (3 * R))(
        *[t.data_ptr() for t in planes], *[g.data_ptr() for g in geoms],
        *[t.shape[1] for t in planes])
    launches = -(-R // MAX_PHASE_STEP_REGIONS)
    try:
        _launch("phase_step", index, desc,
                None if rowmask is None else rowmask.data_ptr(),
                out.data_ptr(), ws.data_ptr(), R, W, capacity,
                launches=launches)
    except RuntimeError:
        # a launch after the first refused: the slots the first reserved
        # are never released by a last block
        ws.zero_()
        raise
    if rowmask is not None:
        ROWMASK_LAUNCHES["phase_step"] += launches
    return out


def read_phase_step(out: torch.Tensor, R: int, W: int):
    """``phase_step``'s ``out`` on the host: (counts (R, W) int64, key (n,)
    int64, word (n,) int64), the entries sorted by key (row-major,
    column-ascending).  The counts, n and the first ``PHASE_STEP_PREFIX``
    entries come in one copy; the rest, where there is any, in one
    more."""
    head = R * W + 1
    first = out[:min(out.shape[0], head + 2 * PHASE_STEP_PREFIX)]
    first = first.cpu().numpy()
    n = int(first[head - 1])
    if 2 * n > out.shape[0] - head:
        raise RuntimeError(f"phase_step: {n} candidate entries exceed the "
                           f"flush's {(out.shape[0] - head) // 2} words "
                           "(stale counters)")
    ent = first[head:head + 2 * n]
    if n > PHASE_STEP_PREFIX:
        ent = np.concatenate([ent, out[head + 2 * PHASE_STEP_PREFIX:
                                       head + 2 * n].cpu().numpy()])
    ent = ent.reshape(n, 2)
    order = np.argsort(ent[:, 0], kind="stable")
    return first[:R * W].reshape(R, W), ent[order, 0], ent[order, 1]


def candidate_cells(key: np.ndarray, word: np.ndarray, W: int):
    """The set bits of sorted candidate entries as host (region, row,
    column) arrays, region-major, then row-major and column-ascending:
    the reference's sequential worker-major flush order."""
    bits = ((word[:, None] & _M32) >> np.arange(32)) & 1
    ei, j = np.nonzero(bits)
    rw = key[ei] >> 32
    return rw // W, rw % W, 32 * (key[ei] & _M32) + j


def phase_step_dense(planes, geoms, rowmask=None):
    """``phase_step`` in the reference's layout: (counts (R, W) int64,
    shared (R, W, nw) int32, nw the widest plane's word count), from the
    kernel on a card and the plain version on the CPU, as host tensors.
    The tests hold it against ``_phase_step_np``."""
    R, W = len(planes), planes[0].shape[0]
    nw = max((p.shape[1] + 31) // 32 for p in planes)
    counts, key, word = read_phase_step(phase_step(planes, geoms, rowmask),
                                        R, W)
    shared = np.zeros(R * W * nw, np.int64)
    shared[(key >> 32) * nw + (key & _M32)] = word
    return (torch.from_numpy(np.ascontiguousarray(counts)),
            _as_i32(torch.from_numpy(shared)).reshape(R, W, nw))


def phase_step_inputs(rng: np.random.Generator, R: int, W: int, caps,
                      device, dead_rows: bool, mask: bool, step=None):
    """Flush operands as the engine holds them, for the tests and the
    smoke's on-card check: each region's bool dirty plane (W, caps[r])
    and (3, W) int32 geometry (rows with base=-1, dead, hold no bits;
    live bounds sorted; INT32_MAX pads), and a random (R, W) row mask, or
    None as the engine passes it.  Live windows start every ``step`` pages
    (default cap - 1) and half of them span the whole cap, so with the
    default a window overlaps its neighbour by one page, like a
    prefetching read, and coverage changes inside words; a small ``step``
    stacks many windows on each page."""
    planes, geoms = [], []
    for r, C in enumerate(caps):
        plane = np.zeros((W, C), bool)
        geom = np.full((3, W), _I32_MAX, np.int32)
        geom[0] = -1
        nlive = int(rng.integers(1, W + 1)) if dead_rows else W
        rows = np.sort(rng.choice(W, nlive, replace=False))
        b = (r * 10_000_000 + rows * (step or C - 1)).astype(np.int32)
        ln = np.where(rng.random(nlive) < 0.5, C,
                      rng.integers(max(C // 2, 1), C + 1, nlive))
        geom[0, rows] = b
        geom[1, :nlive] = np.sort(b)
        geom[2, :nlive] = np.sort(b + ln)
        for i, w in enumerate(rows):
            plane[w, :ln[i]] = rng.random(int(ln[i])) < 0.5
        planes.append(torch.as_tensor(plane, device=device))
        geoms.append(torch.as_tensor(geom, device=device))
    rowmask = (torch.as_tensor(rng.random((R, W)) < 0.9, device=device)
               if mask else None)
    return planes, geoms, rowmask


def _check_rows(plane: torch.Tensor, name: str):
    """Raise unless ``plane`` is (R, C) bool rows whose cells are
    contiguous (any row stride), as the row kernels read them."""
    if not (plane.dtype is torch.bool and plane.dim() == 2
            and (plane.shape[1] < 2 or plane.stride(1) == 1)):
        check(plane, name, torch.bool, 2, plane.device)


def _rank_operands(live: torch.Tensor, k):
    """Check a rank-select call's operands: ``live`` (R, C) bool rows,
    each row's cells contiguous (any row stride), and the ranks ``k``:
    (R,) int32 or int64 on the same device, or an int when R == 1.
    Returns (the ranks as int32 for the kernel, or None; the rank by
    value): int64 ranks are clipped to the int32 range (the rank of any
    real row is far below it, so clipping changes no result)."""
    _check_rows(live, "live")
    R = live.shape[0]
    if not isinstance(k, torch.Tensor):
        if R != 1:
            raise ValueError(f"a rank by value takes one row, not {R}")
        return None, int(k)
    if k.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"k must be int32 or int64, got {k.dtype}")
    check(k, "k", k.dtype, 1, live.device)
    if k.shape[0] != R:
        raise ValueError(f"k has {k.shape[0]} ranks for {R} rows")
    if k.dtype == torch.int64:
        k = torch.clamp(k, -_I32_MAX - 1, _I32_MAX).to(torch.int32)
    return k, 0


def _plain_ranks(k, dev) -> torch.Tensor:
    if isinstance(k, torch.Tensor):
        return k
    return torch.tensor([int(k)], dtype=torch.int64, device=dev)


def _rank_launch(name: str, live: torch.Tensor, k32, kv, *outs):
    if live.shape[0]:
        _launch(name, live.device, live.data_ptr(), live.stride(0),
                live.shape[0], live.shape[1],
                None if k32 is None else k32.data_ptr(), kv,
                *[o.data_ptr() for o in outs], None)


def take_first_k(live: torch.Tensor, k) -> torch.Tensor:
    """(R, C) bool run rows + ranks -> (R, C) bool: each row's first k[i]
    set cells.  ``live`` may be a view with any row stride (the kernel
    reads it in place); ``k`` is (R,) int32 or int64 on its device, or an
    int when R == 1."""
    _called("take_first_k")
    k32, kv = _rank_operands(live, k)
    if not on_card(live):
        return _take_first_k_bool_plain(live, _plain_ranks(k, live.device))
    take = live.new_empty(live.shape)
    _rank_launch("take_first_k", live, k32, kv, take)
    return take


def kth_set_index(live: torch.Tensor, k) -> torch.Tensor:
    """(R, C) bool run rows + 1-based ranks -> (R,) int64 column of each
    row's k[i]-th set cell, -1 when k[i] <= 0 or the row has fewer set
    cells.  Operands as for ``take_first_k``."""
    _called("kth_set_index")
    k32, kv = _rank_operands(live, k)
    if not on_card(live):
        return _kth_set_index_bool_plain(live, _plain_ranks(k, live.device))
    cut = torch.empty(live.shape[0], dtype=torch.int64, device=live.device)
    _rank_launch("kth_set_index", live, k32, kv, cut)
    return cut


def take_and_cut(live: torch.Tensor,
                 k) -> Tuple[torch.Tensor, torch.Tensor]:
    """``take_first_k`` and ``kth_set_index`` of the same operands in one
    launch: (take (R, C) bool, cut (R,) int64)."""
    _called("take_and_cut")
    k32, kv = _rank_operands(live, k)
    if not on_card(live):
        kp = _plain_ranks(k, live.device)
        return (_take_first_k_bool_plain(live, kp),
                _kth_set_index_bool_plain(live, kp))
    take = live.new_empty(live.shape)
    cut = torch.empty(live.shape[0], dtype=torch.int64, device=live.device)
    _rank_launch("take_and_cut", live, k32, kv, take, cut)
    return take, cut


def take_run(live: torch.Tensor, k: int, fused: bool = True) -> torch.Tensor:
    """One run's victim scan in the form the host reads in one copy
    (``read_take_run``): ``live`` a (C,) bool run, its cells contiguous
    (a view of a plane row as it lies), and the rank ``k`` by value ->
    int64 [cut, count, col_0 .. col_{count-1}]: the columns of the first
    k set cells (count = clamp(k, 0, set cells)) and the column of the
    k-th, -1 when there is none.  ``fused``: one ``take_and_cut`` launch;
    otherwise ``take_first_k`` and ``kth_set_index``, each filling its
    part of the one buffer.  The buffer has room for clamp(k, 0, C)
    columns, of which ``count`` are written."""
    if fused:
        _called("take_and_cut")
    else:
        _called("take_first_k")
        _called("kth_set_index")
    if not (live.dtype is torch.bool and live.dim() == 1
            and (live.shape[0] < 2 or live.stride(0) == 1)):
        check(live, "live", torch.bool, 1, live.device)
    k = int(k)
    if not live.is_cuda:
        on_card(live)
        return _take_run_plain(live, k)
    C = live.shape[0]
    buf = torch.empty(2 + min(max(k, 0), C), dtype=torch.int64,
                      device=live.device)
    index, p, b = live.get_device(), live.data_ptr(), buf.data_ptr()
    if fused:
        _launch("take_and_cut", index, p, C, 1, C, None, k, None, None, b)
    else:
        _launch("take_first_k", index, p, C, 1, C, None, k, None, b)
        _launch("kth_set_index", index, p, C, 1, C, None, k, None, b)
    return buf


def read_take_run(buf: torch.Tensor) -> Tuple[int, np.ndarray]:
    """``take_run``'s buffer on the host, in one copy: (cut, the taken
    cells' columns, int64)."""
    a = buf.cpu().numpy()
    return int(a[0]), a[2:2 + int(a[1])]
