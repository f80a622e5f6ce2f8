"""The RegC gradient-sync policy (the port of ``RegCSyncPolicy`` of the
reference's ``regc_sync/policies.py``), which ``TrainHParams.sync``
carries.

* ``ordinary_sync``: 'lazy' (RegC: bulk gradients accumulated locally and
  synced once at the step barrier) or 'eager' (synced at every
  microbatch, the release-consistency baseline);
* ``granularity``: 'bucket' (page-like buckets of ``bucket_bytes``) or
  'object' (one reduction a parameter);
* ``compression``: None or 'int8_ring'.

The sync itself (``span_reduce``, the buckets, the int8 ring) runs over
several processes and waits for ROADMAP item 13d; one-process training
takes only the default policy (``make_train_step`` raises on another).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RegCSyncPolicy:
    ordinary_sync: str = "lazy"          # 'lazy' (RegC) | 'eager' (RC baseline)
    granularity: str = "bucket"          # 'bucket' (page-like) | 'object' (fine)
    bucket_bytes: int = 64 << 20
    compression: Optional[str] = None    # None | 'int8_ring'

    def __post_init__(self):
        assert self.ordinary_sync in ("lazy", "eager")
        assert self.granularity in ("bucket", "object")
        assert self.compression in (None, "int8_ring")
