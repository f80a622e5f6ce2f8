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
* ``diff_apply(dst, mask, vals)`` -> float32 (n, W): vals where
  mask != 0, dst elsewhere (the merge onto a home copy or a cached copy).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current stream, adding
one to ``LAUNCHES[name]`` per launch and to ``CALLS[name]`` per call on
any device.  A tensor on the CPU takes the kernel's plain PyTorch
version (``_*_plain``, on ``int32`` views so it is bit-exact); a CUDA
tensor gets the kernel or an exception, never the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import Kernels, check, on_card, ptr

_I32_MAX = (1 << 31) - 1

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_KERNELS = Kernels("page_diff.cu", {
    "diff_encode": (_P, _P, _P, _P, _P, _L, _L),
    "diff_apply": (_P, _P, _P, _P, _L),
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


def _diff_encode_plain(curr: torch.Tensor, twin: torch.Tensor):
    c = curr.view(torch.int32)
    changed = c != twin.view(torch.int32)
    vals = torch.where(changed, c, torch.zeros((), dtype=torch.int32,
                                               device=c.device))
    return (changed.to(torch.int8), vals.view(torch.float32),
            changed.sum(1, dtype=torch.int32))


def _diff_apply_plain(dst: torch.Tensor, mask: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    return torch.where(mask != 0, vals.view(torch.int32),
                       dst.view(torch.int32)).view(torch.float32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _pages(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device):
    check(t, name, dtype, 2, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def diff_encode(curr: torch.Tensor, twin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, W) float32 pages and their twins -> (mask int8 (n, W), vals
    float32 (n, W), count int32 (n,))."""
    _called("diff_encode")
    dev = curr.device
    _pages("curr", curr, torch.float32, curr.shape, dev)
    _pages("twin", twin, torch.float32, curr.shape, dev)
    if not on_card(dev):
        return _diff_encode_plain(curr, twin)
    n, w = curr.shape
    if n > _I32_MAX:
        raise ValueError(f"diff_encode: {n} pages exceed the grid")
    mask = torch.empty((n, w), dtype=torch.int8, device=dev)
    vals = torch.empty((n, w), dtype=torch.float32, device=dev)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("diff_encode", dev, ptr(curr), ptr(twin), ptr(mask),
                ptr(vals), ptr(count), n, w)
    return mask, vals, count


def diff_apply(dst: torch.Tensor, mask: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """(n, W) float32 ``dst``, int8 ``mask`` and float32 ``vals`` -> a new
    (n, W) float32 array: ``vals`` where ``mask != 0``, ``dst`` elsewhere."""
    _called("diff_apply")
    dev = dst.device
    _pages("dst", dst, torch.float32, dst.shape, dev)
    _pages("mask", mask, torch.int8, dst.shape, dev)
    _pages("vals", vals, torch.float32, dst.shape, dev)
    if not on_card(dev):
        return _diff_apply_plain(dst, mask, vals)
    out = torch.empty_like(dst)
    if out.numel():
        _launch("diff_apply", dev, ptr(dst), ptr(mask), ptr(vals),
                ptr(out), out.numel())
    return out
