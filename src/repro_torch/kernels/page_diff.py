"""Page twin-diff kernels of the RegC consistency-region release.

A span snapshots a *twin* of each page it writes; at release the fine
protocol diffs the current page against its twin word by word and ships
only the changed words plus a bitmask.  Pages are (n, page_words) float32
rows, and a word is compared and copied as its 32-bit pattern (memcmp
semantics: -0.0 against +0.0, NaN payloads and denormals are changes).

Hand-written CUDA kernels (``csrc/page_diff.cu``, ``sm_90a``):

* ``diff_encode(curr, twin)`` -> (mask int8 (n, W), vals float32 (n, W),
  count int32 (n,)): mask = curr != twin bitwise, vals = curr where
  changed and +0.0 elsewhere, count = changed words per page;
  ``bounds=True`` returns an int32 (3, n) block in place of count: count,
  first changed word (W where none) and last changed word (-1 where
  none) per page, the fine release's change bounds, from the same pass;
* ``diff_apply(dst, mask, vals)`` -> a new float32 array: vals where
  mask != 0, dst elsewhere (the merge onto a refetched cached copy);
* ``diff_apply_(dst, mask, vals)`` -> ``dst``, merged in place;
* ``diff_apply_rows_(home, rows, mask, vals)`` -> ``home``, with row
  ``rows[i]`` of ``home`` merged in place with ``mask[i]``/``vals[i]``,
  all rows in one launch.

The merges take one page (W,) or a stack of pages (n, W); the three
operands of one call have one shape.

Where the port updates in place: JAX's arrays are immutable, so the
reference's merges return a new page that the engine stores back.  The
port's reference engine (``core.regc``) overwrites the home copy with
the merge in both places it merges onto home -- the ordinary flush
(``diff_apply_``) and the fine release (``diff_apply_rows_``, given the
sorted, unique home rows of the released pages) -- so merging in place
saves the second device copy of the flush and the gather and scatter of
the release, and writes only the changed words.  The fetch overlay must
leave home as it is, and keeps the functional ``diff_apply``.

Each wrapper checks device, dtype, shape and contiguity and launches on
the current stream, adding one to ``LAUNCHES[name]`` per launch and to
``CALLS[name]`` per call on any device.  A tensor on the CPU takes the
kernel's plain PyTorch version (``_*_plain``, on ``int32`` views so it is
bit-exact); a CUDA tensor gets the kernel or an exception, never the
plain version.  ``rows`` must be sorted and unique, within ``home``: the
plain version checks it, and on the card the kernel stops with a
device-side fault on a row out of range or out of order, since checking
it on the host would wait for the card.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import Kernels, check, on_card

_I32_MAX = (1 << 31) - 1

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_KERNELS = Kernels("page_diff.cu", {
    "diff_encode": (_P, _P, _P, _P, _P, _L, _L),
    "diff_apply": (_P, _P, _P, _P, _L),
    "diff_apply_": (_P, _P, _P, _L),
    "diff_apply_rows_": (_P, _P, _P, _P, _L, _L, _L),
})
# launch counters: one per kernel, bumped only where a kernel launches;
# CALLS counts each wrapper's calls on any device
LAUNCHES = _KERNELS.launches
CALLS = _KERNELS.calls
reset_launches = _KERNELS.reset
_launch = _KERNELS.launch
_F32, _I8 = torch.float32, torch.int8


# ---------------------------------------------------------------------------
# plain versions (CPU tier and the kernels' on-card comparison)
# ---------------------------------------------------------------------------


def _diff_encode_plain(curr: torch.Tensor, twin: torch.Tensor,
                       bounds: bool = False):
    c = curr.view(torch.int32)
    changed = c != twin.view(torch.int32)
    vals = torch.where(changed, c, torch.zeros((), dtype=torch.int32,
                                               device=c.device))
    count = changed.sum(1, dtype=torch.int32)
    if bounds:
        n, w = changed.shape
        if w:
            col = torch.arange(w, dtype=torch.int32, device=c.device)
            first = torch.where(changed, col, w).amin(1)
            last = torch.where(changed, col, -1).amax(1)
        else:
            first = torch.zeros(n, dtype=torch.int32, device=c.device)
            last = torch.full((n,), -1, dtype=torch.int32, device=c.device)
        count = torch.stack([count, first, last])
    return changed.to(torch.int8), vals.view(torch.float32), count


def _diff_apply_plain(dst: torch.Tensor, mask: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    return torch.where(mask != 0, vals.view(torch.int32),
                       dst.view(torch.int32)).view(torch.float32)


def _diff_apply_plain_(dst: torch.Tensor, mask: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    d = dst.view(torch.int32)
    d.copy_(torch.where(mask != 0, vals.view(torch.int32), d))
    return dst


def _diff_apply_rows_plain_(home: torch.Tensor, rows: torch.Tensor,
                            mask: torch.Tensor,
                            vals: torch.Tensor) -> torch.Tensor:
    h = home.view(torch.int32)
    h[rows] = torch.where(mask != 0, vals.view(torch.int32), h[rows])
    return home


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _pages(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device):
    check(t, name, dtype, 2, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def _merge_operands(dst: torch.Tensor, mask: torch.Tensor,
                    vals: torch.Tensor) -> int:
    """Raise unless ``dst`` and ``vals`` are float32, ``mask`` int8, all
    contiguous, one page (W,) or pages (n, W) of one shape, on one
    device (one combined test when all hold).  Returns the device index
    (-1 for the CPU)."""
    shape = dst.shape
    if (dst.dtype is _F32 and mask.dtype is _I8 and vals.dtype is _F32
            and mask.shape == shape and vals.shape == shape
            and 1 <= len(shape) <= 2 and dst.is_contiguous()
            and mask.is_contiguous() and vals.is_contiguous()):
        index = dst.get_device()
        if mask.get_device() == index and vals.get_device() == index:
            return index
    if dst.dim() not in (1, 2):
        raise ValueError(f"dst must be a page (W,) or pages (n, W), got "
                         f"shape {tuple(shape)}")
    for name, t, dtype in (("dst", dst, _F32), ("mask", mask, _I8),
                           ("vals", vals, _F32)):
        check(t, name, dtype, dst.dim(), dst.device)
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
    raise AssertionError("unreachable")


def _encode_operands(curr: torch.Tensor, twin: torch.Tensor) -> int:
    """Raise unless ``curr`` and ``twin`` are contiguous float32 pages
    (n, W) of one shape on one device (one combined test when all hold).
    Returns the device index (-1 for the CPU)."""
    if (curr.dtype is _F32 and twin.dtype is _F32 and curr.dim() == 2
            and twin.shape == curr.shape and curr.is_contiguous()
            and twin.is_contiguous()):
        index = curr.get_device()
        if twin.get_device() == index:
            return index
    dev = curr.device
    _pages("curr", curr, _F32, curr.shape, dev)
    _pages("twin", twin, _F32, curr.shape, dev)
    raise AssertionError("unreachable")


def diff_encode(curr: torch.Tensor, twin: torch.Tensor, *,
                bounds: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, W) float32 pages and their twins -> (mask int8 (n, W), vals
    float32 (n, W), count int32 (n,)).  With ``bounds``, the third output
    is an int32 (3, n) block in place of ``count``: each page's count,
    first changed word (W where none) and last changed word (-1 where
    none), from the same pass."""
    CALLS["diff_encode"] += 1
    index = _encode_operands(curr, twin)
    if not on_card(curr):
        return _diff_encode_plain(curr, twin, bounds)
    n, w = curr.shape
    if n > _I32_MAX or w > _I32_MAX:
        raise ValueError(f"diff_encode: {n} pages of {w} words exceed the "
                         "grid")
    # three allocations: carving one buffer into the three outputs takes
    # more host time (its slices and dtype views) than it saves
    mask = torch.empty((n, w), dtype=_I8, device=index)
    vals = torch.empty((n, w), dtype=_F32, device=index)
    stats = torch.empty((3, n), dtype=torch.int32, device=index)
    if n:
        _launch("diff_encode", index, curr.data_ptr(), twin.data_ptr(),
                mask.data_ptr(), vals.data_ptr(), stats.data_ptr(), n, w)
    return mask, vals, stats if bounds else stats[0]


def diff_apply(dst: torch.Tensor, mask: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """float32 ``dst``, int8 ``mask`` and float32 ``vals`` of one shape
    ((W,) or (n, W)) -> a new float32 array: ``vals`` where ``mask != 0``,
    ``dst`` elsewhere."""
    CALLS["diff_apply"] += 1
    index = _merge_operands(dst, mask, vals)
    if not on_card(dst):
        return _diff_apply_plain(dst, mask, vals)
    out = torch.empty_like(dst)
    total = out.numel()
    if total:
        _launch("diff_apply", index, dst.data_ptr(), mask.data_ptr(),
                vals.data_ptr(), out.data_ptr(), total)
    return out


def diff_apply_(dst: torch.Tensor, mask: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``diff_apply`` into ``dst``: its words where ``mask != 0`` become
    ``vals``' (bit for bit), the rest stay; returns ``dst``."""
    CALLS["diff_apply_"] += 1
    index = _merge_operands(dst, mask, vals)
    if not on_card(dst):
        return _diff_apply_plain_(dst, mask, vals)
    total = dst.numel()
    if total:
        _launch("diff_apply_", index, dst.data_ptr(), mask.data_ptr(),
                vals.data_ptr(), total)
    return dst


def diff_apply_rows_(home: torch.Tensor, rows: torch.Tensor,
                     mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Merge (n, W) ``mask``/``vals`` into rows ``rows`` (int64 (n,),
    sorted, unique, within ``home``) of the float32 (n_pages, W) ``home``
    in place, in one launch: ``home[rows[i]]`` takes ``vals[i]`` where
    ``mask[i] != 0``.  Returns ``home``."""
    CALLS["diff_apply_rows_"] += 1
    dev = home.device
    check(home, "home", _F32, 2, dev)
    check(rows, "rows", torch.int64, 1, dev)
    n, w = rows.shape[0], home.shape[1]
    _pages("mask", mask, _I8, (n, w), dev)
    _pages("vals", vals, _F32, (n, w), dev)
    if not on_card(home):
        if n and (int(rows[0]) < 0 or int(rows[-1]) >= home.shape[0]
                  or bool((rows[1:] <= rows[:-1]).any())):
            raise ValueError("rows must be sorted, unique and within home")
        return _diff_apply_rows_plain_(home, rows, mask, vals)
    if n > _I32_MAX:
        raise ValueError(f"diff_apply_rows_: {n} rows exceed the grid")
    if n and w:
        _launch("diff_apply_rows_", dev, home.data_ptr(), rows.data_ptr(),
                mask.data_ptr(), vals.data_ptr(), n, w, home.shape[0])
    return home
