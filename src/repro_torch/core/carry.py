"""Carry a protocol state across from the reference package.

Two carriers, one per engine:

* ``reference_from_state`` turns a live reference ``RegCRuntime`` (the
  per-page engine) into this package's ``RegCRuntime`` on any device,
  reading its attributes by duck typing: page values, caches, dirty
  intervals and masks, LRU order, locks with their notices, open spans
  with their twins, traffic, clocks, pending reductions and race state.
* ``runtime_from_snapshot`` builds the scale engine from a snapshot.
  The reference's ``RegCScaleRuntime.snapshot()`` serializes its complete
  state at a barrier cut as plain numpy arrays plus JSON-serializable
  meta (its directory planes in ``RegionDirectory.state_arrays`` format,
  its lock logs in ``IntervalLog.state_arrays`` format).  Only state the
  scale port can run so far is accepted: chaos and straggler hooks and
  shard slices raise a ``ValueError``.  Eviction state (``cache_pages``,
  the resident counts, the LRU run queues and the directories'
  touch/incache planes) and race-detection state (the vector clocks of
  the workers and the locks, the flagged set and the directories' race
  planes) carry over.

Either way a trace can start on the reference and finish here with the
same traffic and bit-equal clocks: the system's counterpart of carrying
a model's weights across.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.core import regc
from repro_torch.core.directory import IntervalLog, RegionDirectory
from repro_torch.core.regc import RegCRuntime, Traffic
from repro_torch.core.regc_scale import RegCScaleRuntime, _Lock
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


def _refuse(why: str):
    raise ValueError(f"runtime_from_snapshot: {why} is not ported yet")


def runtime_from_snapshot(arrays: dict, meta: dict, *, device=None,
                          backend: str = "fused") -> RegCScaleRuntime:
    """A runtime of this package whose every later event matches the
    reference runtime the snapshot was taken from."""
    if meta.get("slice") is not None:
        _refuse("a shard-slice snapshot (compose the slices first;"
                " the cluster slice)")
    cfg = meta["config"]
    if meta.get("chaos") is not None or meta.get("straggler") is not None:
        _refuse("chaos/straggler state (the recovery slice)")
    cache_pages = cfg.get("cache_pages")
    rt = RegCScaleRuntime(
        int(cfg["n_workers"]), page_words=int(cfg["page_words"]),
        protocol=cfg["protocol"], cost=CostModel(**meta["cost"]),
        prefetch=int(cfg["prefetch"]),
        model_mechanism=bool(cfg["model_mechanism"]),
        instr_s_per_word=float(cfg["instr_s_per_word"]),
        fault_s=float(cfg["fault_s"]),
        fetch_batch=int(cfg["fetch_batch"]), backend=backend,
        cache_pages=None if cache_pages is None else int(cache_pages),
        danger_mode=cfg.get("danger_mode", "vec"),
        detect_races=bool(cfg.get("detect_races", False)), device=device)
    rt.n_pages = int(meta["n_pages"])
    rt._region_starts = [int(x) for x in meta["region_starts"]]
    rt._region_ends = [int(x) for x in meta["region_ends"]]
    rt._region_starts_np = np.asarray(rt._region_starts, np.int64)
    rt.dirs = []
    for r, dmeta in enumerate(meta["dirs"]):
        pre = f"d{r:05d}_"
        darr = {k[len(pre):]: v for k, v in arrays.items()
                if k.startswith(pre)}
        d = RegionDirectory.from_state(darr, dmeta, backend=backend,
                                       device=rt.device)
        d.stats = rt.stats
        rt.dirs.append(d)
    rt.locks = {}
    for j, lm in enumerate(meta["locks"]):
        pre = f"lk{j:05d}_"
        lk = _Lock(rt.W)
        lk.version = int(lm["version"])
        lk.seen = np.asarray(arrays[pre + "seen"], np.int64).copy()
        lk.last_release_time = float(np.asarray(arrays[pre + "lrt"])[0])
        lk.log = IntervalLog.from_state(
            {k: arrays[pre + k] for k in ("p", "lo", "hi", "voff")})
        if pre + "vc" in arrays:
            lk.race_vc = np.asarray(arrays[pre + "vc"], np.int64).copy()
        rt.locks[int(lm["id"])] = lk
    if rt.detect_races:
        rt.race_vc = np.asarray(arrays["race_vc"], np.int64).copy()
        # race_set rows are (page, a, b, kind) with kind 0 for 'ww'
        rs = np.asarray(arrays["race_set"], np.int64).reshape(-1, 4)
        rt.races = {(int(p), int(a), int(b), "ww" if k == 0 else "rw")
                    for p, a, b, k in rs}
    rt.clock = np.asarray(arrays["clock"], np.float64).copy()
    rt._bar_clock0 = np.asarray(arrays["bar_clock0"], np.float64).copy()
    rt.resident = np.asarray(arrays["resident"], np.int64).copy()
    rt._q_degraded = np.asarray(arrays["q_degraded"], bool).copy()
    # LRU run queues: flat (N, 7) entries plus per-worker counts
    ents = np.asarray(arrays["lru_entries"], np.int64).reshape(-1, 7)
    offs = np.concatenate([[0], np.cumsum(
        np.asarray(arrays["lru_counts"], np.int64))])
    rt._lru_q = [deque([int(x) for x in e]
                       for e in ents[offs[w]:offs[w + 1]])
                 for w in range(rt.W)]
    counts = np.asarray(arrays["dirty_region_counts"], np.int64)
    flat = np.asarray(arrays["dirty_region_flat"], np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    rt._dirty_regions = [set(int(x) for x in flat[offs[w]:offs[w + 1]])
                         for w in range(rt.W)]
    rt.traffic = Traffic(**meta["traffic"])
    for k, v in meta["stats"].items():
        if k in rt.stats:
            rt.stats[k] = int(v)
    rt._tick = int(meta["tick"])
    rt._phase_idx = int(meta["phase_idx"])
    rt._reduction_results = {
        k: float(v) for k, v in zip(
            meta["red_names"], np.asarray(arrays["red_vals"], np.float64))}
    return rt
