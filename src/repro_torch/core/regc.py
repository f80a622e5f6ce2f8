"""Data types shared by the RegC runtimes: the exact traffic ledger and
the global-address-space allocation handle.

The per-page reference engine (``RegCRuntime`` in the reference package)
is not ported yet; this module holds only what the directory-vectorized
engine needs from it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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


@dataclasses.dataclass
class GasArray:
    """Handle to a page-aligned allocation in the global address space."""
    page_lo: int
    n_elems: int
    page_words: int

    def word_range_in_page(self, p: int, lo: int, hi: int) -> Tuple[int, int]:
        base = (p - self.page_lo) * self.page_words
        return max(lo - base, 0), min(hi - base, self.page_words)
