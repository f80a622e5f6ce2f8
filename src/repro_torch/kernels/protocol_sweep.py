"""Bitmask protocol-sweep kernels for the RegC sharing directory.

The directory's boolean page-state planes (one row per worker, see
``core.directory.RegionDirectory``) pack 32 pages per word: bit ``j`` of
word ``k`` in row ``w`` is directory column ``32*k + j`` of worker ``w``
(little-endian).  Packed words are stored as ``torch.int32`` and read as
unsigned by the kernels; the plain versions do their bit arithmetic in
int64 (torch's CPU build lacks shifts on uint32).

Hand-written CUDA kernels (``csrc/protocol_sweep.cu``, ``sm_90a``):

* ``pack_rows``      (W, C) bool plane -> (W, ceil(C/32)) packed words;
* ``popcount_rows``  per-row set-bit counts (the barrier-flush writeback
  charge and the eviction engine's dirty-victim counts);
* ``coverage_multi`` running cover of the sorted +1/-1 window-bound
  deltas, >= 2 (the shared-interval sweep);
* ``phase_step``     the fused barrier flush over R stacked regions:
  per-row popcount, coverage stab, and the packed shared-dirty candidate
  mask (dirty & multi-covered & active row), in one launch;
* ``take_first_k``   per-row rank-select: each row's first k[i] set bits
  (the segment-LRU victim mask of batched eviction);
* ``kth_set_index``  per-row rank query: the column of the k[i]-th set
  bit, -1 out of range (the refetch replay's victim-scan cut);
* ``take_and_cut``   both of the last two in one launch.

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
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import Kernels, check, on_card

_M32 = 0xFFFFFFFF
_I32_MAX = (1 << 31) - 1
# phase_step stages 2W int32 bounds in dynamic shared memory and opts in
# past the 48 KiB default: stay within Hopper's 227 KiB a block, less
# 1 KiB for its static shared memory (72 bytes) and the dynamic array's
# alignment
MAX_PHASE_STEP_W = (227 * 1024 - 1024) // 8

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_KERNELS = Kernels("protocol_sweep.cu", {
    "pack_rows": (_P, _P, _L, _L, _L),
    "popcount_rows": (_P, _P, _L, _L),
    "coverage_multi": (_P, _P, _L),
    "phase_step": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _L),
    "take_first_k": (_P, _P, _P, _L, _L),
    "kth_set_index": (_P, _P, _P, _L, _L),
    "take_and_cut": (_P, _P, _P, _P, _L, _L),
})
# launch counters: one per kernel, bumped only where a kernel launches;
# CALLS counts each wrapper's calls on any device
LAUNCHES = _KERNELS.launches
CALLS = _KERNELS.calls
reset_launches = _KERNELS.reset
_launch = _KERNELS.launch
_called = _KERNELS.called


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
    return _popcount_words_plain(bits).sum(dim=1)


def _coverage_multi_plain(delta: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(delta.to(torch.int64), dim=0) >= 2


def _phase_step_plain(bits, base, rowmask, sbases, sends):
    """The fused flush chain region by region (the reference's
    ``_phase_step_np``): counts (R, W) int64, shared (R, W, nw) int32."""
    R, W, nw = bits.shape
    dev = bits.device
    counts = _popcount_words_plain(bits).sum(dim=2)
    col = (torch.arange(nw, dtype=torch.int64, device=dev)[:, None] * 32
           + torch.arange(32, dtype=torch.int64, device=dev)[None, :])
    lanes = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    shared = torch.zeros_like(bits)
    for r in range(R):
        active = rowmask[r] & (counts[r] > 0)
        page = base[r].to(torch.int64)[:, None, None] + col[None]
        flat = page.reshape(-1)
        cov = (torch.searchsorted(sbases[r].to(torch.int64), flat,
                                  right=True)
               - torch.searchsorted(sends[r].to(torch.int64), flat,
                                    right=True))
        multi = (cov >= 2).reshape(page.shape)
        mbits = torch.where(multi, lanes, zero).sum(dim=-1)     # (W, nw)
        hit = torch.where(active[:, None], _u32(bits[r]) & mbits, zero)
        shared[r] = _as_i32(hit)
    return counts, shared


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


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def pack_rows(plane: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(W, C) bool -> packed (W, ceil(C/32)) int32 words.  ``out`` may be
    a wider (W, nw_out) int32 buffer; words past ceil(C/32) become 0."""
    _called("pack_rows")
    dev = plane.device
    check(plane, "plane", torch.bool, 2, dev)
    W, C = plane.shape
    nw = -(-C // 32)
    if out is None:
        out = torch.empty((W, nw), dtype=torch.int32, device=dev)
    check(out, "out", torch.int32, 2, dev)
    if out.shape[0] != W or out.shape[1] < nw:
        raise ValueError(f"out shape {tuple(out.shape)} cannot hold "
                         f"({W}, {nw}) packed words")
    if not on_card(plane):
        out.zero_()
        out[:, :nw] = _pack_rows_plain(plane)
        return out
    if W > 65535:
        raise ValueError(f"pack_rows: W={W} exceeds the grid's 65535 rows")
    if W and out.shape[1]:
        _launch("pack_rows", dev, plane.data_ptr(), out.data_ptr(), W, C,
                out.shape[1])
    return out


def popcount_rows(bits: torch.Tensor) -> torch.Tensor:
    """(W, nw) int32 packed words -> (W,) int64 per-row set-bit counts."""
    _called("popcount_rows")
    dev = bits.device
    check(bits, "bits", torch.int32, 2, dev)
    W, nw = bits.shape
    if not on_card(bits):
        return _popcount_rows_plain(bits)
    if W == 0 or nw == 0:
        return torch.zeros(W, dtype=torch.int64, device=dev)
    counts = torch.empty(W, dtype=torch.int64, device=dev)
    _launch("popcount_rows", dev, bits.data_ptr(), counts.data_ptr(), W, nw)
    return counts


def coverage_multi(delta: torch.Tensor) -> torch.Tensor:
    """Sorted-bound deltas (+1 window start / -1 window end), int32 ->
    bool mask of sweep points whose running cover count is >= 2."""
    _called("coverage_multi")
    dev = delta.device
    check(delta, "delta", torch.int32, 1, dev)
    if not on_card(delta):
        return _coverage_multi_plain(delta)
    out = torch.empty(delta.shape[0], dtype=torch.uint8, device=dev)
    if delta.shape[0]:
        _launch("coverage_multi", dev, delta.data_ptr(), out.data_ptr(),
                delta.shape[0])
    return out.view(torch.bool)


def phase_step(bits: torch.Tensor, base: torch.Tensor,
               rowmask: torch.Tensor, sbases: torch.Tensor,
               sends: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused barrier-flush chain: R stacked regions' packed dirty
    planes ``bits`` (R, W, nw) int32, row window offsets ``base`` (R, W)
    int32 (-1 rows hold no bits), flush mask ``rowmask`` (R, W) bool, and
    sorted live window bounds ``sbases``/``sends`` (R, W) int32 padded
    with INT32_MAX.  Returns (counts (R, W) int64, shared (R, W, nw)
    int32): per-row dirty counts and the packed dirty & >=2-covered &
    active-row candidate masks."""
    _called("phase_step")
    dev = bits.device
    check(bits, "bits", torch.int32, 3, dev)
    R, W, nw = bits.shape
    for name, t, dt in (("base", base, torch.int32),
                        ("rowmask", rowmask, torch.bool),
                        ("sbases", sbases, torch.int32),
                        ("sends", sends, torch.int32)):
        check(t, name, dt, 2, dev)
        if tuple(t.shape) != (R, W):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(R, W)}")
    if not on_card(bits):
        return _phase_step_plain(bits, base, rowmask, sbases, sends)
    if W > MAX_PHASE_STEP_W or R > 65535:
        raise ValueError(f"phase_step: (R, W)=({R}, {W}) exceeds the "
                         f"kernel's limits (R <= 65535, W <= "
                         f"{MAX_PHASE_STEP_W})")
    counts = torch.empty((R, W), dtype=torch.int64, device=dev)
    shared = torch.empty_like(bits)
    if R and W:
        _launch("phase_step", dev, bits.data_ptr(), base.data_ptr(),
                rowmask.data_ptr(), sbases.data_ptr(), sends.data_ptr(),
                counts.data_ptr(), shared.data_ptr(), R, W, nw)
    return counts, shared


def _rank_operands(bits: torch.Tensor, k: torch.Tensor):
    """Check a rank-select call's operands: (R, nw) int32 words and (R,)
    int32 or int64 ranks on the same device.  Returns the ranks as int32
    for the kernel, clipped to the int32 range (the rank of any real row
    is far below it, so clipping changes no result)."""
    dev = bits.device
    check(bits, "bits", torch.int32, 2, dev)
    if k.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"k must be int32 or int64, got {k.dtype}")
    check(k, "k", k.dtype, 1, dev)
    if k.shape[0] != bits.shape[0]:
        raise ValueError(f"k has {k.shape[0]} ranks for {bits.shape[0]} rows")
    if k.dtype == torch.int64:
        k = torch.clamp(k, -_I32_MAX - 1, _I32_MAX).to(torch.int32)
    return dev, k


def take_first_k(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(R, nw) int32 packed rows + (R,) ranks -> (R, nw) int32: each row's
    first k[i] set bits in little-endian column order."""
    _called("take_first_k")
    dev, k32 = _rank_operands(bits, k)
    R, nw = bits.shape
    if not on_card(bits):
        return _take_first_k_plain(bits, k)
    take = torch.empty_like(bits)
    if R and nw:
        _launch("take_first_k", dev, bits.data_ptr(), k32.data_ptr(),
                take.data_ptr(), R, nw)
    return take


def kth_set_index(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(R, nw) int32 packed rows + (R,) 1-based ranks -> (R,) int64 column
    of each row's k[i]-th set bit, -1 when k[i] <= 0 or the row has fewer
    set bits."""
    _called("kth_set_index")
    dev, k32 = _rank_operands(bits, k)
    R, nw = bits.shape
    if nw == 0:
        return torch.full((R,), -1, dtype=torch.int64, device=dev)
    if not on_card(bits):
        return _kth_set_index_plain(bits, k)
    cut = torch.empty(R, dtype=torch.int64, device=dev)
    if R:
        _launch("kth_set_index", dev, bits.data_ptr(), k32.data_ptr(),
                cut.data_ptr(), R, nw)
    return cut


def take_and_cut(bits: torch.Tensor,
                 k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``take_first_k`` and ``kth_set_index`` of the same operands in one
    launch: (take (R, nw) int32, cut (R,) int64)."""
    _called("take_and_cut")
    dev, k32 = _rank_operands(bits, k)
    R, nw = bits.shape
    if nw == 0:
        return (torch.empty_like(bits),
                torch.full((R,), -1, dtype=torch.int64, device=dev))
    if not on_card(bits):
        return _take_first_k_plain(bits, k), _kth_set_index_plain(bits, k)
    take = torch.empty_like(bits)
    cut = torch.empty(R, dtype=torch.int64, device=dev)
    if R:
        _launch("take_and_cut", dev, bits.data_ptr(), k32.data_ptr(),
                take.data_ptr(), cut.data_ptr(), R, nw)
    return take, cut
