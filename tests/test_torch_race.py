"""Race detection on the scale engine (slice E of the port) against the
reference ``repro.core``, on the CPU.

* ``RegionDirectory``'s race planes: ``race_note``, ``race_note_rows``,
  ``race_hits`` and the batched ``race_hits_many`` against the
  reference's directory on seeded windows, notes and views; windows
  that grow left and right and through ``_grow_cap``; eviction that
  leaves the planes alone; ``state_arrays``/``from_state`` both ways.
* Lockstep on ``trace_fuzz.gen_race_program`` traces, the twin of
  ``trace_fuzz.race_crosscheck``: the port's ``loop`` and ``batched``
  drivers on its plain, kernels and fused tiers against the reference's
  scale engine (numpy) with detection on: the race set, traffic and
  clocks after every event, the race planes at the end; a detection-off
  port run bit-equal (the pure observer); the port's per-page reference
  engine with the same final set and counts; racy traces flagged and
  clean ones silent.  A sample of the 120 seeds by default (racy and
  clean, every ``cache_pages`` of ``race_trace_params``); all 120 under
  ``FUZZ_TORCH=1``.
* The reference's pinned tuples, lock ordering and eviction cases.
* Path coverage: phase ops that take the batched check and the pair
  sweep, and ``span_all`` calls whose grant chains flag races.
* ``apps.race_audit`` at W in {4, 16}, fine and page, both drivers.
* Carry-in: a reference snapshot taken mid-run with detection on goes
  on in the port and finishes with the reference's race set.
* ``chip_smoke``'s copies: ``race_program`` against ``gen_race_program``
  and ``md_false_sharing`` against the reference's race set of MD.

Tolerance: race sets and counts equal, ``Traffic`` exact, clocks
bit-equal (``atol=0``), planes equal cell for cell.
"""
import dataclasses
import os

import numpy as np
import pytest

import chip_smoke
import trace_fuzz
from repro.core import RegCRuntime as RefOracle
from repro.core import make_runtime as ref_make
from repro.core.directory import RegionDirectory as RefDir
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.dsm import apps as ref_apps
from repro.dsm.costmodel import IB_2013 as REF_IB
from repro_torch.core import make_runtime as pt_make
from repro_torch.core import runtime_from_snapshot
from repro_torch.core.directory import RegionDirectory as PortDir
from repro_torch.core.directory import use_dense
from repro_torch.core.regc import GasArray
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime
from repro_torch.dsm import apps as pt_apps
from repro_torch.dsm.costmodel import IB_2013 as PT_IB

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
N_RACE = 120
# racy (odd) and clean (even) seeds over every cache_pages (seed % 4)
RACE_SEEDS = (tuple(range(N_RACE)) if FUZZ
              else (0, 1, 2, 3, 6, 7, 9, 13, 15, 18, 22, 24, 25, 27, 34,
                    37, 39, 41, 50, 58, 67, 80, 99, 113))
PORT_TIERS = ("plain", "kernels", "fused")
DRIVERS = ("batched", "loop")


def _traffic(rt):
    return dataclasses.asdict(rt.traffic)


# ---------------------------------------------------------------------------
# (a) the directory's race planes
# ---------------------------------------------------------------------------


def _assert_race_planes(ref, pt, ctx=""):
    np.testing.assert_array_equal(pt.base, ref.base, err_msg=str(ctx))
    np.testing.assert_array_equal(pt.length, ref.length, err_msg=str(ctx))
    assert (pt.race_w is None) == (ref.race_w is None), ctx
    if ref.race_w is None:
        return
    np.testing.assert_array_equal(pt.race_w.numpy(), ref.race_w,
                                  err_msg=str(ctx))
    np.testing.assert_array_equal(pt.race_r.numpy(), ref.race_r,
                                  err_msg=str(ctx))
    np.testing.assert_array_equal(pt.race_maxw, ref.race_maxw)
    np.testing.assert_array_equal(pt.race_maxr, ref.race_maxr)


def _noted_pair(seed, W=6, P=200, n_ops=40):
    """A reference and a port directory through the same seeded window
    growth (left, right, through ``_grow_cap``) and race notes."""
    rng = np.random.default_rng(700 + seed)
    ref = RefDir(W, 0, 0, P)
    pt = PortDir(W, 0, 0, P, device="cpu")
    for step in range(n_ops):
        w = int(rng.integers(0, W))
        lo = int(rng.integers(0, P - 30))
        hi = lo + int(rng.integers(1, 30))
        for d in (ref, pt):
            d.ensure(w, lo, hi)
        if rng.random() < 0.3:
            rows = rng.permutation(W)[:int(rng.integers(1, W + 1))]
            rlo = rng.integers(0, P - 30, rows.size)
            rhi = rlo + rng.integers(1, 30, rows.size)
            ep = rng.integers(1, 20, W)
            wr = bool(rng.random() < 0.5)
            for d in (ref, pt):
                d.ensure_rows(rlo, rhi, rows)
                d.race_note_rows(rows, rlo, rhi, ep, wr)
        else:
            a = int(rng.integers(lo, hi))
            b = int(rng.integers(a + 1, hi + 1))
            ep, wr = int(rng.integers(1, 20)), bool(rng.random() < 0.5)
            for d in (ref, pt):
                d.race_note(w, a, b, ep, wr)
        _assert_race_planes(ref, pt, (seed, step))
    return rng, ref, pt


@pytest.mark.parametrize("seed", range(6))
def test_race_notes_and_windows_match(seed):
    _, ref, pt = _noted_pair(seed)
    assert pt.cap == ref.cap and pt.shift.tolist() == ref.shift.tolist()


@pytest.mark.parametrize("seed", range(3))
def test_wide_race_notes_match(seed):
    """Ranges past ``use_dense``'s cutoff store as slices grouped by
    column span (shared spans, lone spans, rows out of order)."""
    rng = np.random.default_rng(800 + seed)
    W, P = 16, 24000
    ref = RefDir(W, 0, 0, P)
    pt = PortDir(W, 0, 0, P, device="cpu")
    for step in range(6):
        rows = rng.permutation(W)[:int(rng.integers(8, W + 1))]
        lo = np.where(rng.random(rows.size) < 0.6, 100,
                      rng.integers(0, 4000, rows.size))
        hi = lo + np.where(rng.random(rows.size) < 0.6, 9000,
                           rng.integers(8200, 12000, rows.size))
        assert not use_dense(rows.size, int((hi - lo).max()))
        ep = rng.integers(1, 30, W)
        for d in (ref, pt):
            d.ensure_rows(lo, hi, rows)
            d.race_note_rows(rows, lo, hi, ep, bool(step % 2))
        _assert_race_planes(ref, pt, (seed, step))


@pytest.mark.parametrize("seed", range(6))
def test_race_hits_and_batched_check_match(seed):
    rng, ref, pt = _noted_pair(seed)
    n = 30
    p_lo = rng.integers(0, 190, n)
    p_hi = p_lo + rng.integers(1, 40, n)
    views = rng.integers(0, 20, (n, ref.W))
    got = pt.race_hits_many(p_lo, p_hi, views, (True, False))
    for k, is_write in enumerate((True, False)):
        want = [ref.race_hits(int(p_lo[i]), int(p_hi[i]), views[i],
                              is_write) for i in range(n)]
        checks, rows, pages = got[k]
        for i in range(n):
            m = checks == i
            np.testing.assert_array_equal(rows[m], want[i][0])
            np.testing.assert_array_equal(pages[m], want[i][1])
            u, p = pt.race_hits(int(p_lo[i]), int(p_hi[i]), views[i],
                                is_write)
            np.testing.assert_array_equal(u, want[i][0])
            np.testing.assert_array_equal(p, want[i][1])
    assert sum(g[0].size for g in got) > 0, "no check fired"


def test_batched_check_chunks(monkeypatch):
    """A check wider than ``RACE_CELLS`` cells, in several round trips,
    gives the one-trip answer."""
    rng, _, pt = _noted_pair(1)
    p_lo = rng.integers(0, 190, 12)
    p_hi = p_lo + rng.integers(1, 40, 12)
    views = rng.integers(0, 20, (12, pt.W))
    whole = pt.race_hits_many(p_lo, p_hi, views, (True, False))
    monkeypatch.setattr(PortDir, "RACE_CELLS", 5)
    for a, b in zip(whole, pt.race_hits_many(p_lo, p_hi, views,
                                             (True, False))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_race_check_without_planes_is_empty():
    d = PortDir(3, 0, 0, 50, device="cpu")
    d.ensure(0, 0, 10)
    u, p = d.race_hits(0, 10, np.zeros(3, np.int64), True)
    assert u.size == 0 and p.size == 0


def test_eviction_leaves_race_planes_alone():
    rt = PortRuntime(3, page_words=16, cache_pages=4, device="cpu",
                     detect_races=True)
    ga = rt.alloc(16 * 40)
    rt.write(1, ga, 0, 64)
    d = rt.dirs[0]
    before = d.race_w.clone(), d.race_r.clone()
    for k in range(6):
        rt.read(1, ga, 160 + 64 * k, 160 + 64 * k + 32)
    assert rt.stats["race_rw"] == 0 and not d.incache[1, :4].any()
    n = before[0].shape[1]
    assert (d.race_w[:, :n] == before[0]).all()
    assert (d.race_w[1, :4] > 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_race_state_roundtrips(seed):
    _, ref, pt = _noted_pair(seed)
    arrays, meta = ref.state_arrays()
    assert meta["has_race"]
    moved = PortDir.from_state(arrays, meta, backend="fused", device="cpu")
    _assert_race_planes(ref, moved)
    back, back_meta = moved.state_arrays()
    assert back_meta["has_race"] and back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ours, our_meta = pt.state_arrays()
    again = RefDir.from_state(ours, dict(our_meta, backend="numpy"))
    _assert_race_planes(again, pt)


# ---------------------------------------------------------------------------
# (b) lockstep with the reference on the race trace family
# ---------------------------------------------------------------------------


def _race_program(seed):
    p = trace_fuzz.race_trace_params(seed)
    prog = trace_fuzz.gen_race_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["racy"])
    return p, prog


def _kw(p):
    return dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
                model_mechanism=False, cache_pages=p["cache_pages"])


@pytest.mark.parametrize("seed", RACE_SEEDS)
def test_race_lockstep(seed):
    p, prog = _race_program(seed)
    kw = _kw(p)
    n = p["n_words"]
    refs = {d: RefRuntime(p["W"], backend="numpy", detect_races=True, **kw)
            for d in DRIVERS}
    ports = {(t, d): PortRuntime(p["W"], backend=t, device="cpu",
                                 detect_races=True, **kw)
             for t in PORT_TIERS for d in DRIVERS}
    off = PortRuntime(p["W"], backend="fused", device="cpu", **kw)
    runs = [(rt, d) for d, rt in refs.items()]
    runs += [(rt, d) for (_, d), rt in ports.items()] + [(off, "batched")]
    gas = {id(rt): [rt.alloc(n), rt.alloc(n)] for rt, _ in runs}
    for i, ev in enumerate(prog):
        for rt, d in runs:
            trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
        for (tier, d), pt in ports.items():
            ref = refs[d]
            ctx = (seed, p["proto"], p["cache_pages"], tier, d, i, ev[0])
            assert pt.races == ref.races, (ctx, pt.races ^ ref.races)
            assert pt.race_counts == ref.race_counts, ctx
            assert _traffic(pt) == _traffic(ref), ctx
            np.testing.assert_allclose(pt.clock, ref.clock, rtol=0, atol=0,
                                       err_msg=str(ctx))
        assert refs["loop"].races == refs["batched"].races
        assert _traffic(off) == _traffic(refs["batched"]), (seed, i)
        np.testing.assert_allclose(off.clock, refs["batched"].clock,
                                   rtol=0, atol=0)
    assert not off.races and off.race_counts == {"race_ww": 0, "race_rw": 0}
    for (tier, d), pt in ports.items():
        for rd, pd in zip(refs[d].dirs, pt.dirs):
            _assert_race_planes(rd, pd, (seed, tier, d, rd.region))
        np.testing.assert_array_equal(pt.race_vc, refs[d].race_vc)
    oracle = pt_make(p["W"], engine="reference", track_values=False,
                     device="cpu", detect_races=True,
                     **{k: v for k, v in kw.items()
                        if k != "model_mechanism"})
    trace_fuzz.run_program(oracle, prog, [oracle.alloc(n), oracle.alloc(n)],
                           "ref")
    batched = ports[("fused", "batched")]
    assert oracle.races == batched.races, oracle.races ^ batched.races
    assert oracle.race_counts == batched.race_counts
    assert bool(batched.races) == p["racy"], (seed, batched.races)


def test_race_sample_covers_the_family():
    """The default sample holds racy and clean traces under every cache
    setting of ``race_trace_params``."""
    seen = {(trace_fuzz.race_trace_params(s)["cache_pages"], s % 2)
            for s in RACE_SEEDS}
    assert seen == {(c, r) for c in (None, 3, 6, 9) for r in (0, 1)
                    if (c in (None, 6)) == (r == 0)}


# ---------------------------------------------------------------------------
# (c) pinned tuples, lock ordering, eviction
# ---------------------------------------------------------------------------


def _mk(W=2, **kw):
    kw.setdefault("page_words", 4)
    kw.setdefault("protocol", "fine")
    kw.setdefault("prefetch", 1)
    kw.setdefault("model_mechanism", False)
    return PortRuntime(W, detect_races=True, device="cpu", **kw)


def test_race_exact_tuples_scale_and_oracle():
    def scenario(rt, ga):
        rt.write(0, ga, 0, 4)
        rt.write(1, ga, 2, 6)          # pages 0 (W/W) and 1
        rt.read(0, ga, 4, 8)           # page 1: unordered vs w1's write
        rt.barrier()
        rt.write(0, ga, 32, 36)        # page 8 ...
        rt.barrier()
        rt.read(1, ga, 32, 36)         # ... read after a barrier: clean
        return ga.page_lo

    rt = _mk()
    P = scenario(rt, rt.alloc(64))
    ref = RefOracle(2, page_words=4, protocol="fine", prefetch=1,
                    track_values=False, detect_races=True)
    P2 = scenario(ref, ref.alloc(64))
    assert rt.races == {(P + 0, 0, 1, "ww"), (P + 1, 0, 1, "rw")}
    assert ref.races == {(P2 + 0, 0, 1, "ww"), (P2 + 1, 0, 1, "rw")}
    assert rt.race_counts == {"race_ww": 1, "race_rw": 1}
    assert ref.race_counts == rt.race_counts


def test_race_lock_ordering():
    rt = _mk()
    ga = rt.alloc(32)
    P = ga.page_lo
    for w in (0, 1):
        rt.acquire(w, 0)
        rt.write(w, ga, 0, 4)
        rt.release(w, 0)
    assert not rt.races, rt.races
    for w, lk in ((0, 1), (1, 2)):
        rt.acquire(w, lk)
        rt.write(w, ga, 4, 8)
        rt.release(w, lk)
    assert rt.races == {(P + 1, 0, 1, "ww")}, rt.races


def test_race_detection_survives_eviction():
    rt = _mk(cache_pages=2)
    ga = rt.alloc(256)
    P = ga.page_lo
    rt.write(1, ga, 0, 4)              # page 0
    for k in range(8):                 # churn w1's cache: page 0 evicts
        rt.read(1, ga, 32 + 16 * k, 32 + 16 * k + 8)
    rt.read(0, ga, 0, 4)               # still unordered vs w1's write
    assert (P + 0, 0, 1, "rw") in rt.races, rt.races


def test_make_runtime_detects_races_on_every_driver():
    rt = pt_make(4, device="cpu", detect_races=True, page_words=16)
    assert rt.detect_races and rt.race_vc.tolist() == np.eye(4).tolist()
    ga = rt.alloc(16 * 8)
    ids = np.arange(4)
    rt.phase_all(writes=[(ga, ids * 16, ids * 16 + 20)])
    rt.span_all(None, ids % 2, writes=[(ga, np.zeros(4, np.int64),
                                        np.full(4, 2, np.int64))])
    rt.barrier()
    rt.phase(0, writes=[(ga, 100, 104)])
    rt.phase(1, reads=[(ga, 100, 104)])
    assert rt.race_counts["race_ww"] > 0 and rt.race_counts["race_rw"] > 0


# ---------------------------------------------------------------------------
# (d) path coverage of the batched detector
# ---------------------------------------------------------------------------


def test_race_sample_drives_the_batched_paths(monkeypatch):
    """Phase ops whose screen fails run the batched check (with hits),
    write ops with overlapping ranges the pair sweep, and ``span_all``
    calls with grant chains of two or more members flag races."""
    seen = {"op_check_hits": 0, "op_pairs": 0, "span_chain_races": 0}
    where = []
    check, pairs, op_all, span_all = (
        PortRuntime._race_check, PortRuntime._race_pairs,
        PortRuntime._race_op_all, PortRuntime._race_span_all)

    def counted_check(self, d, ws, *args):
        n0 = len(self.races)
        check(self, d, ws, *args)
        if where == ["op"] and ws.size > 1 and len(self.races) > n0:
            seen["op_check_hits"] += 1

    def counted_pairs(self, *args):
        out = pairs(self, *args)
        if where == ["op"] and out[0].size:
            seen["op_pairs"] += 1
        return out

    def counted_op(self, *args):
        where.append("op")
        op_all(self, *args)
        where.pop()

    def counted_span(self, rows, locks, reads, writes):
        n0 = len(self.races)
        span_all(self, rows, locks, reads, writes)
        _, counts = np.unique(locks[rows], return_counts=True)
        if counts.max() >= 2 and len(self.races) > n0:
            seen["span_chain_races"] += 1

    for name, fn in (("_race_check", counted_check),
                     ("_race_pairs", counted_pairs),
                     ("_race_op_all", counted_op),
                     ("_race_span_all", counted_span)):
        monkeypatch.setattr(PortRuntime, name, fn)
    for seed in RACE_SEEDS:
        p, prog = _race_program(seed)
        rt = PortRuntime(p["W"], backend="fused", device="cpu",
                         detect_races=True, **_kw(p))
        trace_fuzz.run_program(rt, prog, [rt.alloc(p["n_words"])
                                          for _ in range(2)], "batched")
    assert all(v > 0 for v in seen.values()), seen


# ---------------------------------------------------------------------------
# (e) race_audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proto", ("fine", "page"))
@pytest.mark.parametrize("W", (4, 16))
def test_race_audit_matches_reference(W, proto):
    n = 1 << 16
    for driver in DRIVERS:
        ref = ref_make(W, protocol=proto, cost=REF_IB, fetch_batch=16,
                       detect_races=True)
        ref_apps.race_audit(ref, n, 3, driver=driver)
        assert ref.stats["race_ww"] > 0 and ref.stats["race_rw"] > 0
        for backend in PORT_TIERS:
            pt = pt_make(W, protocol=proto, cost=PT_IB, fetch_batch=16,
                         backend=backend, device="cpu", detect_races=True)
            pt_apps.race_audit(pt, n, 3, driver=driver)
            ctx = (W, proto, driver, backend)
            assert pt.races == ref.races, ctx
            assert pt.race_counts == ref.race_counts, ctx
            assert _traffic(pt) == _traffic(ref), ctx
            np.testing.assert_allclose(pt.clock, ref.clock, rtol=0, atol=0)
            for k in ("span_workers_vec", "span_serial_workers"):
                assert pt.stats[k] == ref.stats[k], (ctx, k)


def test_race_audit_rejects_no_locks():
    rt = pt_make(2, device="cpu", detect_races=True)
    with pytest.raises(ValueError, match="n_locks"):
        pt_apps.race_audit(rt, 64, 1, n_locks=0)


# ---------------------------------------------------------------------------
# (f) carry-in from a reference snapshot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (1, 3, 13))
def test_snapshot_with_race_state_carries_in(seed):
    p, prog = _race_program(seed)
    n = p["n_words"]
    ref = RefRuntime(p["W"], backend="numpy", detect_races=True, **_kw(p))
    gas_r = [ref.alloc(n), ref.alloc(n)]
    cut = next(i for i in range(len(prog) // 2, len(prog))
               if prog[i][0] == "barrier") + 1
    for ev in prog[:cut]:
        trace_fuzz.apply_event(ref, ev, gas_r, "batched")
    arrays, meta = ref.snapshot()
    assert "race_vc" in arrays and any(m["has_race"] for m in meta["dirs"])
    for backend in PORT_TIERS:
        pt = runtime_from_snapshot(arrays, meta, device="cpu",
                                   backend=backend)
        assert pt.detect_races and pt.races == ref.races
        gas_p = [GasArray(g.page_lo, g.n_elems, g.page_words)
                 for g in gas_r]
        twin = RefRuntime.from_snapshot(arrays, meta)
        gas_t = [twin.gas_for_region(r, n) for r in range(2)]
        for i, ev in enumerate(prog[cut:]):
            trace_fuzz.apply_event(twin, ev, gas_t, "batched")
            trace_fuzz.apply_event(pt, ev, gas_p, "batched")
            ctx = (seed, backend, cut + i, ev[0])
            assert pt.races == twin.races, ctx
            assert pt.race_counts == twin.race_counts, ctx
            assert _traffic(pt) == _traffic(twin), ctx
            np.testing.assert_allclose(pt.clock, twin.clock, rtol=0,
                                       atol=0)
        for rd, pd in zip(twin.dirs, pt.dirs):
            _assert_race_planes(rd, pd, (seed, backend))
        if p["racy"]:
            assert pt.races


# ---------------------------------------------------------------------------
# (g) the smoke's copies
# ---------------------------------------------------------------------------


def _normal(prog):
    out = []
    for ev in prog:
        if ev[0] == "phase":
            out.append(("phase", [(g, lo.tolist(), hi.tolist())
                                  for g, lo, hi in ev[1]],
                        [(g, lo.tolist(), hi.tolist())
                         for g, lo, hi in ev[2]]))
        elif ev[0] == "span_phase":
            locks, reads, writes = ev[-3:]
            out.append(("span_phase", np.asarray(locks).tolist(),
                        [(g, lo.tolist(), hi.tolist())
                         for g, lo, hi in reads],
                        [(g, lo.tolist(), hi.tolist())
                         for g, lo, hi in writes]))
        else:
            out.append(ev)
    return out


@pytest.mark.parametrize("seed", chip_smoke.RACE_SEEDS + (1, 5, 10, 77))
def test_smoke_race_program_is_the_fuzz_trace(seed):
    p, prog = _race_program(seed)
    q, ours = chip_smoke.race_program(seed)
    assert {k: p[k] for k in q} == q
    assert _normal(ours) == _normal(prog)


def test_smoke_race_seeds_cover_every_cache():
    caches = [chip_smoke.race_program(s)[0]["cache_pages"]
              for s in chip_smoke.RACE_SEEDS]
    assert caches == [None, 3, 6, 9]


@pytest.mark.parametrize("W", (16, 32))
def test_smoke_md_false_sharing_is_the_reference_set(W):
    ref = ref_make(W, protocol="fine", cost=REF_IB, fetch_batch=16,
                   detect_races=True)
    ref_apps.molecular_dynamics(ref, 8192, 2, mode="lock", driver="batched")
    assert ref.races
    assert chip_smoke.md_false_sharing(ref, 8192) == ref.races
