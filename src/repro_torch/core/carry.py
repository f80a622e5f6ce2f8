"""Carry a protocol state across from the reference package.

Two carriers, one per engine:

* ``reference_from_state`` turns a live reference ``RegCRuntime`` (the
  per-page engine) into this package's ``RegCRuntime`` on any device,
  reading its attributes by duck typing: page values, caches, dirty
  intervals and masks, LRU order, locks with their notices, open spans
  with their twins, traffic, clocks, pending reductions and race state.
* ``runtime_from_snapshot`` builds the scale engine from a snapshot,
  through ``RegCScaleRuntime.from_snapshot``.  The reference's
  ``RegCScaleRuntime.snapshot()`` serializes its complete state at a
  barrier cut as plain numpy arrays plus JSON-serializable meta (its
  directory planes in ``RegionDirectory.state_arrays`` format, its lock
  logs in ``IntervalLog.state_arrays`` format), and this package's
  ``snapshot()`` writes the same format.  Everything carries over:
  eviction state, race-detection state and the chaos and straggler
  counters.  A shard slice (``snapshot(rows=)``) raises a
  ``ValueError``, as the reference refuses it; the snapshot that
  ``compose_snapshots`` builds from the slices restores.

Either way a trace can start on the reference and finish here with the
same traffic and bit-equal clocks: the system's counterpart of carrying
a model's weights across.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import regc
from repro_torch.core.regc import RegCRuntime, Traffic
from repro_torch.core.regc_scale import RegCScaleRuntime
from repro_torch.dsm.costmodel import CostModel


def _traffic(t) -> Traffic:
    return Traffic(**{f.name: int(getattr(t, f.name))
                      for f in dataclasses.fields(Traffic)})


def reference_from_state(src, *, device=None) -> RegCRuntime:
    """This package's per-page ``RegCRuntime``, on ``device``, in the state
    of the reference runtime ``src``: every later event on the two gives
    the same traffic, bit-equal clocks, the same page values and the same
    race set."""
    cost = CostModel(**{f.name: getattr(src.cost, f.name)
                        for f in dataclasses.fields(CostModel)})
    rt = RegCRuntime(int(src.W), page_words=int(src.page_words),
                     protocol=src.protocol, cost=cost,
                     track_values=bool(src.track_values),
                     cache_pages=(None if src.cache_pages is None
                                  else int(src.cache_pages)),
                     prefetch=int(src.prefetch),
                     detect_races=bool(src.detect_races), device=device)

    def page(a):
        return torch.as_tensor(np.array(a, np.float32), device=rt.device)

    rt.n_pages = int(src.n_pages)
    if src.home is not None:
        rt.home = page(src.home)
    rt.cache_data = {(int(w), int(p)): page(v)
                     for (w, p), v in src.cache_data.items()}
    rt.valid = np.array(src.valid, bool)
    rt.lru = [OrderedDict((int(p), True) for p in lru) for lru in src.lru]
    rt.ord_dirty = [{} for _ in range(rt.W)]
    for (w, p), (lo, hi) in src.ord_dirty.items():
        rt.ord_dirty[int(w)][int(p)] = (int(lo), int(hi))
    rt.ord_mask = {(int(w), int(p)): torch.as_tensor(
        np.asarray(m, bool).astype(np.int8), device=rt.device)
        for (w, p), m in src.ord_mask.items()}
    rt.spans = []
    for stack in src.spans:
        ours = []
        for sp in stack:
            s = regc._Span(int(sp.lock))
            s.touched = {int(p): (int(lo), int(hi))
                         for p, (lo, hi) in sp.touched.items()}
            s.twins = {int(p): page(v) for p, v in sp.twins.items()}
            ours.append(s)
        rt.spans.append(ours)
    rt.locks = {}
    for lock_id, lk in src.locks.items():
        ours = regc._Lock(rt.W)
        ours.version = int(lk.version)
        ours.notices = [[(int(p), int(lo), int(hi), None)
                         for (p, lo, hi, _v) in notes]
                        for notes in lk.notices]
        ours.last_release_time = float(lk.last_release_time)
        ours.seen = np.array(lk.seen, np.int64)
        ours.race_vc = np.array(lk.race_vc, np.int64)
        rt.locks[int(lock_id)] = ours
    rt.clock = np.array(src.clock, np.float64)
    rt.traffic = _traffic(src.traffic)
    rt.per_worker_traffic = [_traffic(t) for t in src.per_worker_traffic]
    rt._reductions = {name: [(float(v), str(op)) for v, op in contribs]
                      for name, contribs in src._reductions.items()}
    rt._reduction_results = {name: float(v) for name, v in
                             src._reduction_results.items()}
    rt._barrier_count = int(src._barrier_count)
    if rt.detect_races:
        rt.race_vc = np.array(src.race_vc, np.int64)
        rt._race_wpage = {int(p): np.array(v, np.int64)
                          for p, v in src._race_wpage.items()}
        rt._race_rpage = {int(p): np.array(v, np.int64)
                          for p, v in src._race_rpage.items()}
        rt.races = {(int(p), int(a), int(b), str(k))
                    for p, a, b, k in src.races}
    return rt


def runtime_from_snapshot(arrays: dict, meta: dict, *, device=None,
                          backend: str = "fused",
                          injector=None) -> RegCScaleRuntime:
    """A runtime of this package whose every later event matches the
    runtime the snapshot was taken from (``RegCScaleRuntime.from_snapshot``
    on the ``backend`` tier)."""
    return RegCScaleRuntime.from_snapshot(arrays, meta, injector=injector,
                                          backend=backend, device=device)
