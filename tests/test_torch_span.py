"""Consistency-region spans (slice D of the port) against the reference
``repro.core``, on the CPU.

* ``IntervalLog``: ``append_versions`` leaves the state that repeated
  ``append_version`` calls leave; ``payload_matches`` and
  ``page_bounds`` answer as the reference's on seeded logs, empty
  slices included.
* The masked ``_flush_all_workers`` (``span_all``'s hoisted flush) on
  every port tier after seeded bulk phases, with seeded worker masks:
  planes, dirty bounds, ``maybe_dirty``, traffic and clocks against the
  reference's numpy tier after every flush.
* ``span_all`` in lockstep with the reference's on
  ``trace_fuzz.gen_span_program`` traces (``span_trace_params``; even
  seeds with a third region, so that multi-region grant groups occur),
  on the port's plain/kernels/fused tiers under both drivers, with
  ``model_mechanism`` on and off; the reference's pallas-jit tier runs
  a few of them on the batched driver, and the fused tier's
  ``fused_dispatches`` (masked flushes included) must equal its
  ``jit_dispatches``.  The sample must drive every path of the span
  engine: grant groups, the serial fallbacks, the backlog screen and
  multi-region groups.
* ``lock_contention`` at W in {4, 16} under fine, page and ideal, on
  both drivers; the batched driver runs no span serially.

Tolerance: ``Traffic`` exact, clocks bit-equal (``atol=0``), ``stats``
equal except the reference's ``jit_*`` accounting and the port's
``fused_dispatches``, planes equal cell for cell.  A sample of 24 span
traces runs by default; ``FUZZ_TORCH=1`` runs all 120.
"""
import dataclasses
import os

import numpy as np
import pytest

import trace_fuzz
from repro.core import make_runtime as ref_make
from repro.core.directory import IntervalLog as RefLog
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.dsm import apps as ref_apps
from repro.dsm.costmodel import IB_2013 as REF_IB
from repro.kernels import protocol_sweep as ref_ps
from repro_torch.core import make_runtime as pt_make
from repro_torch.core.directory import IntervalLog as PortLog
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime
from repro_torch.dsm import apps as pt_apps
from repro_torch.dsm.costmodel import IB_2013 as PT_IB

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
N_SPAN = 120
SPAN_SEEDS = (tuple(range(N_SPAN)) if FUZZ
              else (0, 1, 2, 4, 7, 9, 12, 16, 21, 28, 32, 33, 36, 44, 48,
                    56, 63, 64, 72, 81, 88, 100, 104, 116))
JIT_SEEDS = (0, 28, 48, 72)
PORT_TIERS = ("plain", "kernels", "fused")
DRIVERS = ("batched", "loop")
SPAN_KEYS = ("span_all_calls", "span_serial_calls", "span_groups_vec",
             "span_workers_vec", "span_multi_region_groups",
             "span_serial_workers", "span_backlog_serial")


@pytest.fixture(autouse=True, scope="module")
def _restore_jit_accounting():
    """The reference's 'pallas-jit' tier notes every (kernel, shape) it
    dispatches in a process-wide set that feeds its ``jit_cache_misses``
    counter.  Restore the set when this module ends, so test files that
    run later in the same process count their own first dispatches."""
    seen = set(ref_ps._JIT_SEEN)
    yield
    ref_ps._JIT_SEEN.clear()
    ref_ps._JIT_SEEN.update(seen)


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


# ---------------------------------------------------------------------------
# (a) IntervalLog
# ---------------------------------------------------------------------------


def _log_state(log):
    n = log._n
    return (log._p[:n].tolist(), log._lo[:n].tolist(), log._hi[:n].tolist(),
            list(log.voff))


def _random_versions(rng, n_versions):
    out = []
    for _ in range(n_versions):
        k = int(rng.integers(0, 6))
        pages = np.sort(rng.choice(40, k, replace=False)).astype(np.int64)
        los = rng.integers(0, 8, k).astype(np.int64)
        out.append((pages, los, los + rng.integers(1, 9, k)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_append_versions_equals_repeated_append(seed):
    rng = np.random.default_rng(seed)
    one, many = PortLog(), PortLog()
    for chunk in range(4):
        vs = _random_versions(rng, int(rng.integers(0, 5)))
        for p, lo, hi in vs:
            one.append_version(p, lo, hi)
        cat = [np.concatenate([v[i] for v in vs]) if vs
               else np.zeros(0, np.int64) for i in range(3)]
        many.append_versions(*cat, np.array([len(v[0]) for v in vs],
                                            np.int64))
        assert _log_state(one) == _log_state(many), (seed, chunk)
    with pytest.raises(AssertionError):
        many.append_versions(np.zeros(2, np.int64), np.zeros(2, np.int64),
                             np.ones(2, np.int64), np.array([1], np.int64))


@pytest.mark.parametrize("seed", range(6))
def test_payload_matches_and_page_bounds(seed):
    rng = np.random.default_rng(100 + seed)
    ref, pt = RefLog(), PortLog()
    payload = _random_versions(rng, 1)[0]
    for _ in range(int(rng.integers(4, 10))):
        p, lo, hi = (payload if rng.random() < 0.5
                     else _random_versions(rng, 1)[0])
        ref.append_version(p, lo, hi)
        pt.append_version(p, lo, hi)
    nv = len(ref.voff) - 1
    for a in range(nv + 1):
        for b in range(a, nv + 1):
            assert pt.page_bounds(a, b) == ref.page_bounds(a, b), (a, b)
            for cand in (payload, _random_versions(rng, 1)[0]):
                assert (pt.payload_matches(a, b, *cand)
                        == ref.payload_matches(a, b, *cand)), (a, b)
    assert pt.page_bounds(nv, nv) is None
    assert pt.payload_matches(nv, nv, *payload)


# ---------------------------------------------------------------------------
# (b) the masked flush
# ---------------------------------------------------------------------------


def _assert_planes(ref, pt, ctx):
    for rd, pd in zip(ref.dirs, pt.dirs):
        c = (ctx, rd.region)
        np.testing.assert_array_equal(pd.base, rd.base, err_msg=str(c))
        np.testing.assert_array_equal(pd.length, rd.length, err_msg=str(c))
        for name in ("valid", "dirty", "wprot"):
            rp, pp = getattr(rd, name), getattr(pd, name)
            assert (rp is None) == (pp is None), (c, name)
            if rp is not None:
                np.testing.assert_array_equal(pp.numpy(), rp,
                                              err_msg=str((c, name)))
        np.testing.assert_array_equal(pd.dirty_lo, rd.dirty_lo)
        np.testing.assert_array_equal(pd.dirty_hi, rd.dirty_hi)
        assert pd.maybe_dirty == rd.maybe_dirty, c
    assert ([sorted(s) for s in pt._dirty_regions]
            == [sorted(s) for s in ref._dirty_regions]), ctx


@pytest.mark.parametrize("proto", ("fine", "page", "ideal"))
@pytest.mark.parametrize("seed", range(4))
def test_masked_flush_matches_reference(seed, proto):
    rng = np.random.default_rng(300 + seed)
    W = int(rng.integers(2, 7))
    pw = 16
    n_words = pw * int(rng.integers(10, 30))
    kw = dict(page_words=pw, protocol=proto, prefetch=1)
    ref = RefRuntime(W, backend="numpy", **kw)
    pts = {t: PortRuntime(W, backend=t, device="cpu", **kw)
           for t in PORT_TIERS}
    runs = [ref, *pts.values()]
    gas = [[rt.alloc(n_words) for _ in range(2)] for rt in runs]
    n_rounds = 6
    for rnd in range(n_rounds):
        writes = []
        for _ in range(int(rng.integers(1, 3))):
            lo, hi = trace_fuzz._intervals(
                rng, str(rng.choice(trace_fuzz.STYLES)), W, n_words, pw,
                rnd, n_rounds)
            writes.append((int(rng.integers(0, 2)), lo, hi))
        lo, hi = trace_fuzz._intervals(rng, "halo", W, n_words, pw, rnd,
                                       n_rounds)
        for rt, g in zip(runs, gas):
            rt.phase_all(reads=[(g[0], lo, hi)],
                         writes=[(g[r], a, b) for r, a, b in writes])
        mask = rng.random(W) < 0.5
        for rt in runs:
            rt._flush_all_workers(mask)
        for t, pt in pts.items():
            ctx = (seed, proto, t, rnd, mask.tolist())
            _assert_match(ref, pt, ctx)
            _assert_planes(ref, pt, ctx)
        if rng.random() < 0.3:
            for rt in runs:
                rt.barrier()
    if proto != "ideal":
        # the fused tier flushed through phase_step
        assert pts["fused"].stats["fused_dispatches"] > 0


# ---------------------------------------------------------------------------
# (c) span_all in lockstep with the reference
# ---------------------------------------------------------------------------


def _span_program(seed):
    p = trace_fuzz.span_trace_params(seed)
    n_regions = 3 if seed % 2 == 0 else 2
    prog = trace_fuzz.gen_span_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["cache_pages"],
                                       n_regions=n_regions)
    return p, prog, n_regions


def _kw(p, mech):
    return dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
                model_mechanism=mech, cache_pages=p["cache_pages"])


@pytest.mark.parametrize("mech", (True, False), ids=("mech", "nomech"))
@pytest.mark.parametrize("seed", SPAN_SEEDS)
def test_span_all_lockstep(seed, mech):
    p, prog, n_regions = _span_program(seed)
    kw = _kw(p, mech)
    refs = {d: RefRuntime(p["W"], backend="numpy", **kw) for d in DRIVERS}
    jit = (RefRuntime(p["W"], backend="pallas-jit", **kw)
           if seed in JIT_SEEDS and mech else None)
    ports = {(t, d): PortRuntime(p["W"], backend=t, device="cpu", **kw)
             for t in PORT_TIERS for d in DRIVERS}
    runs = [(rt, d) for d, rt in refs.items()]
    runs += [(rt, d) for (_, d), rt in ports.items()]
    if jit is not None:
        runs.append((jit, "batched"))
    gas = {id(rt): [rt.alloc(p["n_words"]) for _ in range(n_regions)]
           for rt, _ in runs}
    for i, ev in enumerate(prog):
        for rt, d in runs:
            trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
        for (tier, d), pt in ports.items():
            ctx = (seed, p["proto"], p["cache_pages"], mech, tier, d, i,
                   ev[0])
            _assert_match(refs[d], pt, ctx)
        if jit is not None:
            assert (ports[("fused", "batched")].stats["fused_dispatches"]
                    == jit.stats["jit_dispatches"]), (seed, i, ev[0])


def test_span_sample_drives_every_path():
    """The default sample reaches every path of the span engine (the
    lockstep test holds the port's counters equal to the reference's)."""
    agg = dict.fromkeys(SPAN_KEYS, 0)
    for seed in SPAN_SEEDS:
        p, prog, n_regions = _span_program(seed)
        rt = PortRuntime(p["W"], backend="fused", device="cpu",
                         **_kw(p, True))
        trace_fuzz.run_program(
            rt, prog, [rt.alloc(p["n_words"]) for _ in range(n_regions)],
            "batched")
        for k in SPAN_KEYS:
            agg[k] += rt.stats[k]
    for k in ("span_groups_vec", "span_serial_calls", "span_backlog_serial",
              "span_multi_region_groups", "span_serial_workers"):
        assert agg[k] > 0, (k, agg)
    assert agg["span_workers_vec"] > agg["span_groups_vec"], agg


def test_span_all_takes_index_masks():
    """``w_mask`` as worker indices (unsorted, repeated) runs the same
    pass as the equivalent bool mask."""
    runs = []
    for mask in (np.array([False, True, False, True, True]),
                 np.array([4, 1, 3, 1])):
        rt = PortRuntime(5, page_words=16, device="cpu")
        ga = rt.alloc(16 * 20)
        ids = np.arange(5, dtype=np.int64)
        rt.phase_all(writes=[(ga, ids * 48, ids * 48 + 40)])
        lo = np.full(5, 300, np.int64)
        rt.span_all(mask, ids % 2, reads=[(ga, lo, lo + 4)],
                    writes=[(ga, lo, lo + 4)])
        runs.append(rt)
    a, b = runs
    assert _traffic(a) == _traffic(b)
    assert a.clock.tobytes() == b.clock.tobytes()
    assert _stats(a) == _stats(b)
    assert a.stats["span_workers_vec"] == 3


def test_span_all_refuses_open_spans():
    rt = PortRuntime(2, page_words=16, device="cpu")
    rt.alloc(64)
    rt.acquire(0, 0)
    with pytest.raises(RuntimeError, match="outside spans"):
        rt.span_all(None, 0)


# ---------------------------------------------------------------------------
# (d) lock_contention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proto", ("fine", "page", "ideal"))
@pytest.mark.parametrize("W", (4, 16))
def test_lock_contention_matches_reference(W, proto):
    n = 1 << 15
    for driver in DRIVERS:
        ref = ref_make(W, protocol=proto, cost=REF_IB, fetch_batch=16)
        ref_apps.lock_contention(ref, n, 3, sweeps=2, driver=driver)
        for backend in PORT_TIERS:
            pt = pt_make(W, protocol=proto, cost=PT_IB, fetch_batch=16,
                         backend=backend, device="cpu")
            pt_apps.lock_contention(pt, n, 3, sweeps=2, driver=driver)
            ctx = (W, proto, driver, backend)
            _assert_match(ref, pt, ctx)
            if driver == "batched":
                assert pt.stats["span_serial_workers"] == 0, ctx
                assert pt.stats["span_workers_vec"] == 3 * 2 * 2 * W, ctx


def test_lock_contention_rejects_no_locks():
    rt = pt_make(2, device="cpu")
    with pytest.raises(ValueError, match="n_locks"):
        pt_apps.lock_contention(rt, 64, 1, n_locks=0)
