"""Eviction under ``cache_pages`` (slice B of the port) against the
reference ``repro.core``, on the CPU.

* Directory primitives of the segment-LRU eviction engine (``run_live``,
  ``lru_take`` including its masked branch, which no trace reaches,
  ``take_upto_row``, ``evict_rows``, ``count_range`` on the wide
  strategy) and the touch/incache state round trip, on every port tier
  against the reference's numpy tier, on seeded planes.
* Lockstep runs of the trace-fuzz families that spill, event by event:
  ``gen_danger_program`` traces (the mid-op refetch adversary) and the
  ``gen_program`` traces with a cache (seeds not divisible by 4), on the
  port's plain/kernels/fused tiers under both drivers against the
  reference's numpy tier, plus the reference's pallas-jit tier on the
  batched driver, whose jit dispatches the fused tier's
  ``fused_dispatches`` must equal.  The port's ``danger_mode="scalar"``
  walk runs against the reference's scalar walk.
* A mid-trace ``runtime_from_snapshot`` handoff under ``cache_pages``.

Tolerance: ``Traffic`` exact, clocks bit-equal (``atol=0``: the port
charges on the host in float64 in the reference's order), ``stats`` equal
except the reference's ``jit_*`` accounting and the port's
``fused_dispatches``.  A sample of 8 seeds per family runs by default;
``FUZZ_TORCH=1`` runs every seed of the reference's corpora (80 danger
traces, 165 cached ``gen_program`` traces).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import trace_fuzz
from repro.core import directory as ref_dir
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.kernels import protocol_sweep as ref_ps
from repro_torch.core import GasArray, runtime_from_snapshot
from repro_torch.core import directory as pt_dir
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
DANGER_SEEDS = (tuple(range(80)) if FUZZ
                else (0, 3, 5, 11, 17, 26, 38, 57))
MIXED_SEEDS = (tuple(s for s in range(220) if s % 4) if FUZZ
               else (1, 2, 7, 13, 30, 45, 62, 99))
PORT_TIERS = ("plain", "kernels", "fused")
DRIVERS = ("batched", "loop")
# the port's tier and the reference tier it twins
TIERS = (("plain", "numpy"), ("kernels", "pallas"), ("fused", "pallas-jit"))


@pytest.fixture(autouse=True, scope="module")
def _restore_jit_accounting():
    """The reference's 'pallas-jit' tier notes every (kernel, shape) it
    dispatches in a process-wide set that feeds its ``jit_cache_misses``
    counter.  Restore the set when this module ends, so test files that
    run later in the same process count their own first dispatches (the
    cluster suite compares that counter with fresh shard processes)."""
    seen = set(ref_ps._JIT_SEEN)
    yield
    ref_ps._JIT_SEEN.clear()
    ref_ps._JIT_SEEN.update(seen)


# ---------------------------------------------------------------------------
# directory primitives
# ---------------------------------------------------------------------------


def _pair(W, cap_pages, seed, tier, *, wprot=True):
    """A reference (numpy) and a port directory with tracked LRU planes,
    driven to the same seeded state: every row's window covers
    [8w, 8w + cap_pages) and its planes hold random cells, ticks drawn
    from a few runs so liveness tests see stale cells."""
    rng = np.random.default_rng(seed)
    ref = ref_dir.RegionDirectory(W, 0, 0, 8 * W + cap_pages,
                                  track_wprot=wprot, track_touch=True)
    pt = pt_dir.RegionDirectory(W, 0, 0, 8 * W + cap_pages,
                                track_wprot=wprot, track_touch=True,
                                backend=tier, device="cpu")
    pt.stats = {"fused_dispatches": 0}
    for w in range(W):
        ref.ensure(w, 8 * w, 8 * w + cap_pages)
        pt.ensure(w, 8 * w, 8 * w + cap_pages)
    n = cap_pages
    for name in ("valid", "dirty", "incache") + (("wprot",) if wprot
                                                 else ()):
        cells = rng.random((W, n)) < 0.6
        getattr(ref, name)[:, :n] = cells
        getattr(pt, name)[:, :n] = torch.from_numpy(cells)
    ticks = rng.integers(1, 4, (W, n))
    ref.touch[:, :n] = ticks
    pt.touch[:, :n] = torch.from_numpy(ticks)
    return ref, pt, rng


def _planes_equal(ref, pt):
    assert pt.cap == ref.cap
    for name in ("base", "length", "shift"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(ref, name))
    for name in ("valid", "dirty", "wprot", "touch", "incache"):
        r = getattr(ref, name)
        if r is not None:
            np.testing.assert_array_equal(getattr(pt, name).numpy(), r,
                                          err_msg=name)


@pytest.mark.parametrize("tier", [t[0] for t in TIERS])
def test_run_live_and_lru_take_match(tier):
    for seed in range(3):
        ref, pt, rng = _pair(9, 70, 10 + seed, tier)
        for rows in (np.arange(9), np.arange(2, 7),
                     np.array([0, 3, 4, 8])):
            start, length = int(rng.integers(0, 20)), int(
                rng.integers(1, 50))
            ticks = rng.integers(1, 4, rows.size)
            live_r = ref.run_live(rows, start, length, ticks)
            live_p = pt.run_live(rows, start, length, ticks)
            np.testing.assert_array_equal(live_p.numpy(), live_r)
            tot = live_r.sum(axis=1)
            k = rng.integers(0, length + 2, rows.size)
            # masked branch (runs not fully live) ...
            np.testing.assert_array_equal(
                pt.lru_take(live_p, k, tot).numpy(),
                ref.lru_take(live_r, k, tot))
            np.testing.assert_array_equal(pt.lru_take(live_p, k).numpy(),
                                          ref.lru_take(live_r, k))
            # ... and the columnar cutoff of fully-live runs
            full = np.full(rows.size, length)
            ones_r = np.ones((rows.size, length), bool)
            np.testing.assert_array_equal(
                pt.lru_take(torch.from_numpy(ones_r), k, full).numpy(),
                ref.lru_take(ones_r, k, full))
    # the fused tier notes its take_first_k launches as fused dispatches
    assert (pt.stats["fused_dispatches"] > 0) == (tier == "fused")


@pytest.mark.parametrize("tier", [t[0] for t in TIERS])
def test_take_upto_row_matches(tier):
    ref, pt, rng = _pair(2, 300, 5, tier)
    for _ in range(12):
        n = int(rng.integers(2, 300))
        live = rng.random(n) < rng.random()
        tot = int(live.sum())
        if tot < 2:
            continue
        k = int(rng.integers(1, tot))          # the caller's k < live cells
        take_r, cut_r = ref.take_upto_row(live, k)
        # the port hands back the victim columns (host) with the cut
        cols_p, cut_p = pt.take_upto_row(torch.from_numpy(live), k)
        np.testing.assert_array_equal(cols_p, np.flatnonzero(take_r))
        assert cut_p == cut_r
        assert cut_p == int(np.flatnonzero(take_r)[-1]) + 1


@pytest.mark.parametrize("tier", [t[0] for t in TIERS])
def test_evict_rows_matches(tier):
    for seed in range(3):
        for set_wprot in (True, False):
            ref, pt, rng = _pair(8, 60, 20 + seed, tier)
            rows = (np.arange(1, 7) if seed != 1
                    else np.array([0, 2, 5, 7]))          # gather rows
            start, length = int(rng.integers(0, 10)), int(
                rng.integers(1, 50))
            db_r = ref.evict_rows(rows, start, length, None,
                                  set_wprot=set_wprot)
            db_p = pt.evict_rows(rows, start, length, None,
                                 set_wprot=set_wprot)
            np.testing.assert_array_equal(db_p, db_r)
            _planes_equal(ref, pt)
            take = rng.random((rows.size, length)) < 0.5
            db_r = ref.evict_rows(rows, start, length, take,
                                  set_wprot=set_wprot)
            db_p = pt.evict_rows(rows, start, length,
                                 torch.from_numpy(take),
                                 set_wprot=set_wprot)
            np.testing.assert_array_equal(db_p, db_r)
            _planes_equal(ref, pt)


def test_count_range_wide_strategy_matches():
    """Intervals past the dense cutoff take the grouped slice sums."""
    ref, pt, rng = _pair(12, 900, 31, "plain")
    for _ in range(4):
        lo = rng.integers(0, 200, 12)
        hi = lo + rng.integers(600, 900, 12)
        lo[3] = hi[3] = 50                               # empty interval
        lo[5:9] = 40
        hi[5:9] = 800                                    # a shared span
        for plane in ("incache", "valid"):
            np.testing.assert_array_equal(
                pt.count_range(getattr(pt, plane), lo, hi),
                ref.count_range(getattr(ref, plane), lo, hi))
        rows = np.array([1, 4, 5, 6, 11])
        np.testing.assert_array_equal(
            pt.count_range(pt.incache, lo[rows], hi[rows], rows=rows),
            ref.count_range(ref.incache, lo[rows], hi[rows], rows=rows))


def test_touch_planes_grow_shift_and_round_trip():
    ref, pt, rng = _pair(4, 30, 40, "fused")
    for w, lo, hi in ((1, 2, 9), (3, 0, 80), (0, 100, 140)):
        ref.ensure(w, lo, hi)
        pt.ensure(w, lo, hi)
    _planes_equal(ref, pt)
    arrays, meta = ref.state_arrays()
    back = pt_dir.RegionDirectory.from_state(arrays, meta, backend="fused",
                                             device="cpu")
    _planes_equal(ref, back)
    b_arrays, b_meta = back.state_arrays()
    assert b_meta["track_touch"]
    for k, v in arrays.items():
        np.testing.assert_array_equal(b_arrays[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# engine lockstep
# ---------------------------------------------------------------------------


def _traffic(rt):
    return dataclasses.asdict(rt.traffic)


def _stats(rt):
    return {k: v for k, v in rt.stats.items()
            if not k.startswith("jit_") and k != "fused_dispatches"}


def _assert_match(ref, pt, ctx):
    assert _traffic(pt) == _traffic(ref), ctx
    np.testing.assert_allclose(pt.clock, ref.clock, rtol=0, atol=0,
                               err_msg=str(ctx))
    assert _stats(pt) == _stats(ref), ctx


def _program(family, seed):
    if family == "danger":
        p = trace_fuzz.danger_trace_params(seed)
        return p, trace_fuzz.gen_danger_program(
            p["rng"], p["W"], p["n_words"], p["page_words"],
            p["cache_pages"])
    p = trace_fuzz.trace_params(seed)
    assert p["cache_pages"] is not None
    return p, trace_fuzz.gen_program(p["rng"], p["W"], p["n_words"],
                                     p["page_words"])


def _kw(p, mech, danger_mode="vec"):
    return dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
                model_mechanism=mech, cache_pages=p["cache_pages"],
                danger_mode=danger_mode)


def _lockstep(family, seed, mech):
    p, prog = _program(family, seed)
    kw = _kw(p, mech)
    refs = {d: RefRuntime(p["W"], backend="numpy", **kw) for d in DRIVERS}
    jit = RefRuntime(p["W"], backend="pallas-jit", **kw)
    ports = {(t, d): PortRuntime(p["W"], backend=t, device="cpu", **kw)
             for t in PORT_TIERS for d in DRIVERS}
    runs = [(rt, d) for d, rt in refs.items()] + [(jit, "batched")]
    runs += [(rt, d) for (_, d), rt in ports.items()]
    gas = {id(rt): [rt.alloc(p["n_words"]) for _ in range(2)]
           for rt, _ in runs}
    for i, ev in enumerate(prog):
        for rt, d in runs:
            trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
        for (tier, d), pt in ports.items():
            ctx = (family, seed, p["proto"], mech, tier, d, i, ev[0])
            _assert_match(refs[d], pt, ctx)
            if tier == "fused" and d == "batched":
                assert (pt.stats["fused_dispatches"]
                        == jit.stats["jit_dispatches"]), ctx
    return refs["batched"].stats


@pytest.mark.parametrize("mech", (True, False), ids=("mech", "nomech"))
@pytest.mark.parametrize("seed", DANGER_SEEDS)
def test_lockstep_danger_program(seed, mech):
    stats = _lockstep("danger", seed, mech)
    # the family is danger-dense: every trace runs the refetch schedule
    assert stats["danger_vec_ops"] > 0 and stats["danger_scalar_ops"] == 0


@pytest.mark.parametrize("seed", MIXED_SEEDS)
def test_lockstep_cached_gen_program(seed):
    _lockstep("mixed", seed, False)


def test_lockstep_samples_cover_the_eviction_paths():
    """The default sample drives every eviction path of the batched
    driver: batched rounds, residual replays, the shared schedule and
    its subgroup split."""
    total = {}
    for family, seeds in (("danger", DANGER_SEEDS), ("mixed", MIXED_SEEDS)):
        for seed in seeds:
            p, prog = _program(family, seed)
            rt = PortRuntime(p["W"], backend="fused", device="cpu",
                             **_kw(p, False))
            gas = [rt.alloc(p["n_words"]) for _ in range(2)]
            trace_fuzz.run_program(rt, prog, gas, "batched")
            for k, v in rt.stats.items():
                total[k] = total.get(k, 0) + v
    for key in ("evict_batch_rounds", "residual_replays", "danger_ops",
                "danger_vec_ops", "danger_shared_ops", "fused_dispatches"):
        assert total[key] > 0, key


@pytest.mark.parametrize("seed", DANGER_SEEDS)
def test_scalar_walk_matches_reference_scalar(seed):
    """``danger_mode="scalar"``: the per-page oracle walk, port against
    reference, both drivers, bit-equal."""
    p, prog = _program("danger", seed)
    kw = _kw(p, True, danger_mode="scalar")
    for d in DRIVERS:
        ref = RefRuntime(p["W"], backend="numpy", **kw)
        pt = PortRuntime(p["W"], backend="fused", device="cpu", **kw)
        gr = [ref.alloc(p["n_words"]) for _ in range(2)]
        gp = [pt.alloc(p["n_words"]) for _ in range(2)]
        for i, ev in enumerate(prog):
            trace_fuzz.apply_event(ref, ev, gr, d)
            trace_fuzz.apply_event(pt, ev, gp, d)
            _assert_match(ref, pt, (seed, d, i, ev[0]))
        assert pt.stats["danger_vec_ops"] == 0
        assert pt.stats["danger_scalar_ops"] > 0


@pytest.mark.parametrize("family,seed", [("danger", 5), ("danger", 26),
                                         ("mixed", 7), ("mixed", 13)])
def test_snapshot_handoff_under_cache_pages(family, seed):
    """The reference runs half a spilling trace; its snapshot (LRU run
    queues, resident counts, touch/incache planes) carries into the port
    on every tier, and both finish the trace in lockstep."""
    p, prog = _program(family, seed)
    cut = len(prog) // 2
    ref = RefRuntime(p["W"], backend="numpy", **_kw(p, True))
    gas_r = [ref.alloc(p["n_words"]) for _ in range(2)]
    for ev in prog[:cut]:
        trace_fuzz.apply_event(ref, ev, gas_r, "batched")
    arrays, meta = ref.snapshot()
    assert int(np.asarray(arrays["lru_counts"]).sum()) > 0
    for backend in PORT_TIERS:
        pt = runtime_from_snapshot(arrays, meta, device="cpu",
                                   backend=backend)
        assert pt.cache_pages == p["cache_pages"]
        _assert_match(ref, pt, (family, seed, backend, "handoff"))
        gas_p = [GasArray(g.page_lo, g.n_elems, g.page_words) for g in gas_r]
        twin = RefRuntime.from_snapshot(arrays, meta)
        gas_t = [twin.gas_for_region(r, p["n_words"]) for r in range(2)]
        for i, ev in enumerate(prog[cut:]):
            trace_fuzz.apply_event(twin, ev, gas_t, "batched")
            trace_fuzz.apply_event(pt, ev, gas_p, "batched")
            _assert_match(twin, pt, (family, seed, backend, cut + i, ev[0]))
