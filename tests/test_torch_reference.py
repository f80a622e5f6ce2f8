"""The port's per-page reference engine (``repro_torch.core.RegCRuntime``,
slice C) against the reference package's ``repro.core.regc.RegCRuntime``,
in lockstep on the CPU.

After every event: traffic and ``per_worker_traffic`` equal field for
field, clocks bit-equal (same algorithm, same order: atol 0), ``valid``,
the LRU order and the dirty intervals equal, and with values ``home``,
every cached copy, every dirty mask and every read bit-equal.  Traces:

* metadata only: ``trace_fuzz.gen_program`` (all cache settings) and
  ``gen_danger_program``, the port driven through its Session's loop
  driver, the reference through raw per-op calls; a sample of seeds by
  default, every seed under ``FUZZ_TORCH=1``;
* with values: the seeded DRF programs, the ordinary-store and
  false-sharing programs of ``tests/test_regc_model.py``, seeded random
  value programs (spans, nested spans, reductions, caches), and the
  ``examples/dsm_jacobi.py`` program (``chip_smoke.dsm_jacobi``) at
  n=32, W=4 for both protocols and both modes;
* ``detect_races=True`` on ``gen_race_program``: equal race sets;
* the paper's apps at W=4 on both references;
* the port's reference against the port's scale engine (the check of
  ``tests/test_directory.py``: traffic equal, clocks allclose 1e-9);
* a mid-trace handoff through ``reference_from_state``, with values;
* the ``make_runtime(engine="reference")`` and ``Session`` contracts.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
import trace_fuzz
from repro.core import make_runtime as ref_make
from repro.core.regc import RegCRuntime as RefRuntime
from repro.dsm import apps as ref_apps
from repro.dsm.session import session as ref_session
from repro_torch.core import (GasArray, RegCRuntime, RuntimeConfig, Traffic,
                              make_runtime, reference_from_state)
from repro_torch.dsm import apps as pt_apps
from repro_torch.dsm.session import session as pt_session
from repro_torch.kernels import page_diff as pd
from test_directory import gen_trace, run_trace
from test_regc_model import _drf_program_np

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
PROGRAM_SEEDS = tuple(range(220)) if FUZZ else (0, 1, 2, 3, 6, 9, 14, 23,
                                                 31, 45)
DANGER_SEEDS = tuple(range(80)) if FUZZ else (0, 3, 5, 11, 26, 57)
RACE_SEEDS = tuple(range(40)) if FUZZ else (0, 1, 2, 3, 5, 10)
PROTOS = ("fine", "page", "ideal")


# ---------------------------------------------------------------------------
# lockstep state checks
# ---------------------------------------------------------------------------


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def assert_same_state(ref, pt, ctx=""):
    assert dataclasses.asdict(pt.traffic) == dataclasses.asdict(
        ref.traffic), ctx
    assert [dataclasses.asdict(t) for t in pt.per_worker_traffic] == [
        dataclasses.asdict(t) for t in ref.per_worker_traffic], ctx
    np.testing.assert_array_equal(pt.clock, ref.clock, err_msg=str(ctx))
    np.testing.assert_array_equal(pt.valid, ref.valid, err_msg=str(ctx))
    assert [list(q) for q in pt.lru] == [list(q) for q in ref.lru], ctx
    dirty = [[(p, iv) for (v, p), iv in ref.ord_dirty.items() if v == w]
             for w in range(ref.W)]
    assert [list(d.items()) for d in pt.ord_dirty] == dirty, ctx
    assert pt._reduction_results == ref._reduction_results, ctx
    if not ref.track_values:
        return
    np.testing.assert_array_equal(_bits(pt.home), _bits(ref.home),
                                  err_msg=str(ctx))
    assert set(pt.cache_data) == set(ref.cache_data), ctx
    for k, v in ref.cache_data.items():
        np.testing.assert_array_equal(_bits(pt.cache_data[k]), _bits(v),
                                      err_msg=str((ctx, k)))
    assert set(pt.ord_mask) == set(ref.ord_mask), ctx
    for k, m in ref.ord_mask.items():
        np.testing.assert_array_equal(pt.ord_mask[k].numpy() != 0, m)


class Pair:
    """One reference and one port runtime driven op by op through the
    reference's runtime API, checked after every op.  Allocations are
    (reference handle, port handle) pairs; reads return the reference's
    values after asserting the port's are bit-equal."""

    def __init__(self, W, ref=None, pt=None, **kw):
        self.ref = ref if ref is not None else RefRuntime(W, **kw)
        self.pt = pt if pt is not None else RegCRuntime(W, device="cpu",
                                                        **kw)
        self.W = W
        self.n_ops = 0

    def check(self):
        self.n_ops += 1
        assert_same_state(self.ref, self.pt, self.n_ops)

    def alloc(self, n):
        ga = (self.ref.alloc(n), self.pt.alloc(n))
        self.check()
        return ga

    def read(self, w, ga, lo, hi):
        a = self.ref.read(w, ga[0], lo, hi)
        b = self.pt.read(w, ga[1], lo, hi)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(_bits(b), _bits(a))
        self.check()
        return a

    def write(self, w, ga, lo, hi, values=None):
        self.ref.write(w, ga[0], lo, hi, values)
        self.pt.write(w, ga[1], lo, hi, None if values is None else
                      torch.as_tensor(np.asarray(values, np.float32)))
        self.check()

    def acquire(self, w, lock):
        self.ref.acquire(w, lock)
        self.pt.acquire(w, lock)
        self.check()

    def release(self, w, lock):
        self.ref.release(w, lock)
        self.pt.release(w, lock)
        self.check()

    def span(self, w, lock):
        return RegCRuntime._SpanCtx(self, w, lock)

    def reduce(self, w, name, value, op="sum"):
        self.ref.reduce(w, name, value, op)
        self.pt.reduce(w, name, value, op)

    def reduction_result(self, name):
        a = self.ref.reduction_result(name)
        assert self.pt.reduction_result(name) == a
        return a

    def barrier(self):
        self.ref.barrier()
        self.pt.barrier()
        self.check()


def apply_port(rt, ev, gas):
    """One ``trace_fuzz`` event on the port's reference engine, its bulk
    phases and span phases through the port's Session loop driver."""
    if ev[0] == "phase":
        _, reads, writes, flops, mem_bytes = ev
        pt_session(rt).phase(
            reads=[(gas[g], lo, hi) for g, lo, hi in reads],
            writes=[(gas[g], lo, hi) for g, lo, hi in writes],
            flops=flops, mem_bytes=mem_bytes)
    elif ev[0] == "span_phase":
        _, mask, locks, reads, writes = ev
        pt_session(rt).span(locks,
                            reads=[(gas[g], lo, hi) for g, lo, hi in reads],
                            writes=[(gas[g], lo, hi) for g, lo, hi in writes],
                            w_mask=mask)
    else:
        trace_fuzz.apply_event(rt, ev, gas, "ref")


def _lockstep(p, prog, *, detect_races=False):
    kw = dict(page_words=p["page_words"], protocol=p["proto"],
              track_values=False, prefetch=1, cache_pages=p["cache_pages"],
              detect_races=detect_races)
    ref = RefRuntime(p["W"], **kw)
    pt = RegCRuntime(p["W"], device="cpu", **kw)
    gas_r = [ref.alloc(p["n_words"]) for _ in range(2)]
    gas_p = [pt.alloc(p["n_words"]) for _ in range(2)]
    for i, ev in enumerate(prog):
        trace_fuzz.apply_event(ref, ev, gas_r, "ref")
        apply_port(pt, ev, gas_p)
        assert_same_state(ref, pt, (i, ev[0]))
        assert pt.races == ref.races, (i, ev[0])
    return ref, pt


# ---------------------------------------------------------------------------
# metadata-only traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", PROGRAM_SEEDS)
def test_lockstep_gen_program(seed):
    p = trace_fuzz.trace_params(seed)
    prog = trace_fuzz.gen_program(p["rng"], p["W"], p["n_words"],
                                  p["page_words"])
    _lockstep(p, prog)


@pytest.mark.parametrize("seed", DANGER_SEEDS)
def test_lockstep_gen_danger_program(seed):
    p = trace_fuzz.danger_trace_params(seed)
    prog = trace_fuzz.gen_danger_program(p["rng"], p["W"], p["n_words"],
                                         p["page_words"], p["cache_pages"])
    _lockstep(p, prog)


@pytest.mark.parametrize("seed", RACE_SEEDS)
def test_race_oracle_matches(seed):
    """The scalar race oracle flags the same (page, a, b, kind) set after
    every event, and stays a pure observer."""
    p = trace_fuzz.race_trace_params(seed)
    prog = trace_fuzz.gen_race_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["racy"])
    ref, pt = _lockstep(p, prog, detect_races=True)
    assert pt.race_counts == ref.race_counts
    assert bool(pt.races) == p["racy"]
    _, off = _lockstep(dict(p), prog)
    np.testing.assert_array_equal(off.clock, pt.clock)
    assert dataclasses.asdict(off.traffic) == dataclasses.asdict(pt.traffic)


# ---------------------------------------------------------------------------
# programs with values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proto", ("fine", "page"))
def test_drf_programs(proto):
    """``_drf_program_np``: span writes of lock 0 in random worker order,
    then a barrier and every worker's read."""
    for seed in range(12):
        rt = Pair(3, page_words=64, protocol=proto)
        g = rt.alloc(128)
        for (w, lo, hi, val) in _drf_program_np(np.random.RandomState(seed)):
            with rt.span(w, 0):
                rt.write(w, g, lo, hi, np.full(hi - lo, val, np.float32))
        rt.barrier()
        for w in range(3):
            rt.read(w, g, 0, 128)


def test_ordinary_store_programs():
    """The ordinary-store program of ``test_regc_model``: single-word
    writes at parity-disjoint locations, a barrier after each."""
    for n_writes in (1, 3, 7, 20):
        rng = np.random.RandomState(n_writes)
        rt = Pair(2, page_words=32, protocol="fine")
        g = rt.alloc(64)
        for i in range(n_writes):
            w = int(rng.randint(2))
            loc = (int(rng.randint(0, 63)) // 2) * 2 + w
            loc = w if loc >= 64 else loc
            rt.write(w, g, loc, loc + 1, np.array([i + 1.0], np.float32))
            rt.barrier()
        for reader in (0, 1):
            rt.read(reader, g, 0, 64)


@pytest.mark.parametrize("proto", ("fine", "page"))
def test_false_sharing_programs(proto):
    """Disjoint words of one page written by several workers (the merge
    at flush and the overlay at fetch), as in ``test_regc_model``."""
    rt = Pair(2, page_words=64, protocol=proto)
    g = rt.alloc(64)
    rt.write(0, g, 0, 4, np.ones(4, np.float32))
    rt.write(1, g, 8, 12, np.full(4, 2, np.float32))
    rt.write(1, g, 5, 6, np.array([3], np.float32))
    rt.barrier()
    rt.read(0, g, 0, 12)
    rt.read(1, g, 0, 12)
    for seed in (0, 1, 2, 3, 17, 1234, 2**31 - 1):
        rng = np.random.RandomState(seed)
        rt = Pair(3, page_words=64, protocol=proto)
        g = rt.alloc(64)
        owner = rng.randint(0, 3, size=64)
        for _ in range(rng.randint(2, 5)):
            for w in range(3):
                pick = rng.choice(np.nonzero(owner == w)[0],
                                  size=rng.randint(1, 5))
                for wd in np.unique(pick):
                    rt.write(w, g, int(wd), int(wd) + 1,
                             np.array([rng.rand() * 10], np.float32))
            if rng.rand() < 0.5:
                with rt.span(rng.randint(0, 3), 0):
                    pass
            rt.barrier()
        for w in range(3):
            rt.read(w, g, 0, 64)


def gen_value_program(rng, W, n_words, n_ops=60):
    """Seeded random program with values over two arrays: ordinary and
    in-span reads and writes, spans nested up to depth 2 over three
    locks (each worker's span ops run back to back), reductions and
    barriers.  Events: ("read", w, a, lo, hi), ("write", w, a, lo, hi,
    vals), ("acquire"/"release", w, lock), ("reduce", w, name, v),
    ("barrier",)."""
    ops = []

    def interval():
        lo = int(rng.integers(0, n_words - 1))
        return lo, min(lo + int(rng.integers(1, 80)), n_words)

    while len(ops) < n_ops:
        kind = rng.random()
        w = int(rng.integers(0, W))
        a = int(rng.integers(0, 2))
        if kind < 0.3:
            ops.append(("read", w, a, *interval()))
        elif kind < 0.6:
            lo, hi = interval()
            ops.append(("write", w, a, lo, hi,
                        rng.standard_normal(hi - lo).astype(np.float32)))
        elif kind < 0.8:
            locks = [int(x) for x in rng.choice(3, int(rng.integers(1, 3)),
                                                replace=False)]
            for lk in locks:
                ops.append(("acquire", w, lk))
            for _ in range(int(rng.integers(1, 4))):
                lo, hi = interval()
                hi = min(hi, lo + 12)
                ops.append(("read", w, a, lo, hi))
                vals = rng.standard_normal(hi - lo).astype(np.float32)
                vals[rng.random(hi - lo) < 0.3] = 0.0     # unchanged words
                ops.append(("write", w, a, lo, hi, vals))
            for lk in reversed(locks):
                ops.append(("release", w, lk))
        elif kind < 0.9:
            ops.append(("reduce", w, "r", float(rng.standard_normal())))
        else:
            ops.append(("barrier",))
    ops.append(("barrier",))
    return ops


def run_ops(rt, ops, gas):
    for op in ops:
        if op[0] == "read":
            rt.read(op[1], gas[op[2]], op[3], op[4])
        elif op[0] == "write":
            rt.write(op[1], gas[op[2]], op[3], op[4], op[5])
        elif op[0] == "acquire":
            rt.acquire(op[1], op[2])
        elif op[0] == "release":
            rt.release(op[1], op[2])
        elif op[0] == "reduce":
            rt.reduce(op[1], op[2], op[3])
        else:
            rt.barrier()


@pytest.mark.parametrize("proto", PROTOS)
@pytest.mark.parametrize("cache_pages", (None, 8))
def test_value_programs(proto, cache_pages):
    for seed in range(4):
        rng = np.random.default_rng(300 + seed)
        rt = Pair(3, page_words=32, protocol=proto, cache_pages=cache_pages)
        gas = [rt.alloc(300), rt.alloc(300)]
        run_ops(rt, gen_value_program(rng, 3, 300), gas)
        for w in range(3):          # in pieces a cache of 8 pages holds
            for lo in range(0, 300, 100):
                rt.read(w, gas[0], lo, lo + 100)


@pytest.mark.parametrize("proto", ("fine", "page"))
@pytest.mark.parametrize("mode", ("lock", "reduction"))
def test_dsm_jacobi_program(proto, mode):
    """The example's program, n=32, W=4, 256-word pages, 60 iterations:
    bit-equal reads, home and traffic after every op."""
    rt = Pair(4, page_words=256, protocol=proto)
    encodes = pd.CALLS["diff_encode"]
    u, err = chip_smoke.dsm_jacobi(rt, 32, 60, mode)
    assert u.shape == (32, 32) and np.isfinite(u).all() and err < 1.0
    if proto == "fine" and mode == "lock":
        assert pd.CALLS["diff_encode"] > encodes


def test_release_batches_the_span_diff():
    """A fine release with values diffs every touched page in one
    ``diff_encode`` call and merges them onto home in place with one
    ``diff_apply_rows_`` (no functional ``diff_apply``, no gather or
    scatter); an untouched-value page is charged by the empty-diff
    rule."""
    rt = Pair(2, page_words=16, protocol="fine")
    g = rt.alloc(80)
    rt.acquire(0, 3)
    rt.write(0, g, 3, 40, np.arange(37, dtype=np.float32))   # pages 0-2
    rt.write(0, g, 50, 52)                                    # page 3, no values
    calls = dict(pd.CALLS)
    rt.release(0, 3)
    assert pd.CALLS["diff_encode"] == calls["diff_encode"] + 1
    assert pd.CALLS["diff_apply_rows_"] == calls["diff_apply_rows_"] + 1
    assert pd.CALLS["diff_apply"] == calls["diff_apply"]
    assert pd.CALLS["diff_apply_"] == calls["diff_apply_"]
    assert [n[:3] for n in rt.pt.locks[3].notices[0]] == [
        (0, 4, 16), (1, 0, 16), (2, 0, 8), (3, 2, 2)]
    rt.acquire(1, 3)
    rt.read(1, g, 0, 80)


# ---------------------------------------------------------------------------
# apps, the scale engine, handoff
# ---------------------------------------------------------------------------

APP_CASES = [("stream_triad", {}, 1 << 14, None),
             ("jacobi", {"mode": "lock"}, 64, None),
             ("jacobi", {"mode": "reduction"}, 64, None),
             ("molecular_dynamics", {"mode": "lock"}, 256, None),
             ("molecular_dynamics", {"mode": "reduction"}, 256, None),
             # a read with values must fit the cache (17 pages here)
             ("stream_spill", {"sweeps": 2}, 1 << 14, 20),
             ("stream_refetch", {"sweeps": 2, "width_pages": 2}, 1 << 14, 5)]


@pytest.mark.parametrize("track_values", (False, True), ids=("meta", "vals"))
@pytest.mark.parametrize("app,kw,n,cache", APP_CASES,
                         ids=[f"{a}-{k.get('mode', '')}" for a, k, _, _
                              in APP_CASES])
def test_apps_match_reference(app, kw, n, cache, track_values):
    for proto in PROTOS:
        cfg = dict(protocol=proto, page_words=256, cache_pages=cache,
                   track_values=track_values)
        ref = ref_make(4, engine="reference", **cfg)
        pt = make_runtime(4, engine="reference", device="cpu", **cfg)
        getattr(ref_apps, app)(ref, n, 2, **kw)
        getattr(pt_apps, app)(pt, n, 2, **kw)
        assert_same_state(ref, pt, (app, proto))


def _assert_scale_close(ref, fast, ctx):
    assert dataclasses.asdict(ref.traffic) == dataclasses.asdict(
        fast.traffic), ctx
    np.testing.assert_allclose(fast.clock, ref.clock, rtol=1e-9, atol=1e-12,
                               err_msg=str(ctx))


def _scale(W, **kw):
    return make_runtime(W, model_mechanism=False, device="cpu", **kw)


@pytest.mark.parametrize("cache_pages", (None, 4, 2, 7))
def test_reference_matches_scale_engine_traces(cache_pages):
    for seed in range(0, 60, 3):
        ops = gen_trace(np.random.default_rng(seed))
        proto = PROTOS[seed % 3]
        pw = (32, 64)[seed % 2]
        ref = RegCRuntime(3, page_words=pw, protocol=proto,
                          track_values=False, cache_pages=cache_pages,
                          device="cpu")
        fast = _scale(3, page_words=pw, protocol=proto,
                      cache_pages=cache_pages)
        run_trace(ref, ops, [ref.alloc(256), ref.alloc(256)])
        run_trace(fast, ops, [fast.alloc(256), fast.alloc(256)])
        _assert_scale_close(ref, fast, (seed, proto, cache_pages))


@pytest.mark.parametrize("proto", ("fine", "page"))
def test_reference_matches_scale_engine_eviction(proto):
    for cache_pages in (3, 6, 11):
        rts = (RegCRuntime(2, page_words=64, protocol=proto,
                           track_values=False, cache_pages=cache_pages,
                           device="cpu"),
               _scale(2, page_words=64, protocol=proto,
                      cache_pages=cache_pages))
        for rt in rts:
            a, b = rt.alloc(640), rt.alloc(640)
            for _ in range(3):
                for w in range(2):
                    for blk in range(5):
                        rt.read(w, a, blk * 128, blk * 128 + 128)
                        rt.write(w, b, blk * 128 + 7, blk * 128 + 121)
                rt.barrier()
        _assert_scale_close(*rts, (proto, cache_pages))
    ref = RegCRuntime(1, page_words=64, track_values=False, cache_pages=2,
                      device="cpu")
    ga = ref.alloc(256)
    ref.write(0, ga, 140, 148)
    ref.read(0, ga, 16, 73)        # the prefetch page is evicted, refetched
    assert ref.traffic.page_fetches == 4


@pytest.mark.parametrize("proto", PROTOS)
def test_reference_matches_scale_engine_apps(proto):
    runs = [(pt_apps.stream_triad, 64 * 1024, 3, {}, None)]
    runs += [(app, n, it, {"mode": m}, None) for m in ("lock", "reduction")
             for app, n, it in ((pt_apps.jacobi, 256, 3),
                                (pt_apps.molecular_dynamics, 256, 2))]
    runs += [(pt_apps.stream_triad, 64 * 1024, 3, {}, 10)]
    for app, n, iters, kw, cache in runs:
        if cache is not None and proto != "fine":
            continue
        ref = make_runtime(4, engine="reference", protocol=proto,
                           track_values=False, cache_pages=cache,
                           device="cpu")
        fast = _scale(4, protocol=proto, cache_pages=cache)
        app(ref, n, iters, **kw)
        app(fast, n, iters, **kw)
        _assert_scale_close(ref, fast, (app.__name__, proto, kw, cache))


@pytest.mark.parametrize("proto", PROTOS)
def test_handoff_mid_trace(proto):
    """A value program runs on the reference up to a cut inside a span
    (open spans with twins, pending notices, dirty masks, reductions),
    is carried over by ``reference_from_state`` and finishes in lockstep
    with the reference."""
    for seed in range(3):
        rng = np.random.default_rng(700 + seed)
        ops = gen_value_program(rng, 3, 300, n_ops=80)
        cut = next(i for i in range(len(ops) // 2, len(ops))
                   if ops[i][0] == "acquire") + 1
        ref = RefRuntime(3, page_words=32, protocol=proto, cache_pages=8,
                         detect_races=True)
        gas = [ref.alloc(300), ref.alloc(300)]
        run_ops(ref, ops[:cut], gas)
        assert any(ref.spans)
        pt = reference_from_state(ref, device="cpu")
        assert_same_state(ref, pt, "handoff")
        rt = Pair(3, ref=ref, pt=pt)
        run_ops(rt, ops[cut:], [(g, g) for g in gas])
        assert pt.races == ref.races


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_make_runtime_reference_contract():
    """``make_runtime(engine="reference")`` builds the port's RegCRuntime
    as the keyword constructor does (scale-only knobs ignored), refuses
    the fault hooks, and runs on the card unless asked for the CPU."""
    for seed in (0, 3):
        p = trace_fuzz.trace_params(seed)
        prog = trace_fuzz.gen_program(p["rng"], p["W"], p["n_words"],
                                      p["page_words"])
        kw = dict(page_words=p["page_words"], protocol=p["proto"],
                  prefetch=1, cache_pages=p["cache_pages"],
                  track_values=False)
        old = RegCRuntime(p["W"], device="cpu", **kw)
        new = make_runtime(p["W"], RuntimeConfig(**kw), engine="reference",
                           device="cpu", backend="kernels", fetch_batch=16,
                           model_mechanism=False)
        assert isinstance(new, RegCRuntime)
        for rt in (old, new):
            gas = [rt.alloc(p["n_words"]) for _ in range(2)]
            for ev in prog:
                apply_port(rt, ev, gas)
        assert dataclasses.asdict(old.traffic) == dataclasses.asdict(
            new.traffic)
        np.testing.assert_array_equal(old.clock, new.clock)
    rt = make_runtime(4, engine="reference", device="cpu", detect_races=True,
                      track_values=False)
    assert rt.detect_races and rt.home is None
    for hook in ("chaos", "injector", "straggler"):
        with pytest.raises(ValueError, match=hook):
            make_runtime(4, engine="reference", device="cpu",
                         **{hook: object()})
    if torch.cuda.is_available():
        assert make_runtime(4, engine="reference").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_runtime(4, engine="reference")


def test_session_on_the_reference_engine():
    """``auto`` picks the loop driver for a runtime without ``phase_all``;
    ``batched`` raises; reductions fall back to per-worker ``reduce``."""
    rt = make_runtime(4, engine="reference", device="cpu", track_values=False)
    s = pt_session(rt)
    assert s.driver == "loop"
    assert pt_session(make_runtime(4, device="cpu")).driver == "batched"
    with pytest.raises(ValueError, match="driver='loop'"):
        pt_session(rt, "batched")
    ref = RefRuntime(4, track_values=False)
    for r, sess in ((rt, s), (ref, ref_session(ref))):
        ga = r.alloc(8192)
        lo = np.arange(4, dtype=np.int64) * 2048
        sess.phase(reads=((ga, lo, lo + 2048),), writes=((ga, lo, lo + 100),),
                   flops=np.arange(4.0) * 1e3, instr_words=5.0)
        sess.reduce("x", 2.0)
        r.barrier()
    assert rt.reduction_result("x") == ref.reduction_result("x") == 8.0
    assert_same_state(ref, rt)


def test_shared_data_types():
    ga = GasArray(4, 100, 32)
    assert list(ga.pages_of(0, 100)) == [4, 5, 6, 7]
    assert list(ga.pages_of(40, 41)) == [5]
    assert list(ga.pages_of(40, 40)) == [5]
    t = Traffic(page_fetches=1, diff_bytes=5)
    t.add(Traffic(page_fetches=2, fetch_bytes=7))
    assert t == Traffic(page_fetches=3, fetch_bytes=7, diff_bytes=5)
