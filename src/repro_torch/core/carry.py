"""Carry a protocol state across from the reference package.

The reference's ``RegCScaleRuntime.snapshot()`` serializes its complete
state at a barrier cut as plain numpy arrays plus JSON-serializable meta
(its directory planes in ``RegionDirectory.state_arrays`` format, its lock
logs in ``IntervalLog.state_arrays`` format).  ``runtime_from_snapshot``
builds this package's runtime from that payload, on any device, so a
trace can start on the reference and finish here with the same traffic
and bit-equal clocks — the system's counterpart of carrying a model's
weights across.

Only state the port can run so far is accepted: chaos and straggler
hooks, race-detection state and shard slices raise a ``ValueError``.
Eviction state (``cache_pages``, the resident counts, the LRU run queues
and the directories' touch/incache planes) carries over.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.directory import IntervalLog, RegionDirectory
from repro_torch.core.regc import Traffic
from repro_torch.core.regc_scale import RegCScaleRuntime, _Lock
from repro_torch.dsm.costmodel import CostModel


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
    if cfg.get("detect_races") or "race_vc" in arrays:
        _refuse("race-detection state (slice D)")
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
        danger_mode=cfg.get("danger_mode", "vec"), device=device)
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
        rt.locks[int(lm["id"])] = lk
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
