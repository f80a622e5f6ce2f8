"""Crash recovery (slice F of the port) against the reference ``repro``
package, on the CPU.

* The fault-tolerance pieces on seeded inputs: ``ChaosNet`` (drop
  decisions, retry charges, invalidation retries, state round trip,
  ``backoff_seconds``), ``StragglerMonitor`` (flags, state round trip),
  ``FailureInjector`` (bare and targeted steps, cluster actions),
  ``mad_threshold`` and ``plan_rescale``.
* The checkpoint store: ``save_arrays``/``load_arrays`` across the two
  packages both ways, ``latest_step``, ``gc_incomplete`` and
  ``CheckpointManager`` rotation.
* ``span_all`` advances ``_phase_idx`` as the reference's does, after
  every event of a span-bearing trace.
* Lockstep on ``trace_fuzz.chaos_trace_params`` traces: the port's plain
  and fused tiers on both drivers against the reference's scale engine
  under the same ``ChaosNet`` and ``StragglerMonitor`` (traffic, clocks
  and ``_phase_idx`` after every event, stats at the end), then the
  port's ``ChaosHarness`` with the trace's injected crashes, bit-equal to
  its uninjected run and to the reference's.  A sample of the 104 seeds
  by default; all of them under ``FUZZ_TORCH=1``.  The sample must fire
  crashes, drops, invalidation retries, straggler flags, grant groups,
  batched eviction and the danger path.
* Race+chaos traces (``race_chaos_crosscheck``'s family): recovery keeps
  the race set.
* Snapshots across the packages: the reference's mid-trace snapshot
  finished on the port, and the port's finished on the reference, both
  bit-equal to the uninterrupted run; the restored directories build
  their device caches anew.
* The four W=16 fig9_recovery rows of ``BENCH_scale.json`` and the
  recovery CSVs' event counters, through ``chip_smoke``'s copies of the
  bench's program, executor and settings.

Tolerance: ``Traffic`` exact, clocks bit-equal (``atol=0``), stats equal
less the tier accounting (the reference's ``jit_*``, the port's
``fused_dispatches``), drop decisions and charges bit-equal.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
import trace_fuzz
from repro.checkpoint import store as ref_store
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.dsm.costmodel import ChaosNet as RefChaos
from repro.ft import coherence as ref_coh
from repro.ft import runtime as ref_ft
from repro_torch.checkpoint import store as pt_store
from repro_torch.core import make_runtime as pt_make
from repro_torch.core import runtime_from_snapshot
from repro_torch.core.regc import GasArray
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime
from repro_torch.dsm.costmodel import ChaosNet as PortChaos
from repro_torch.ft import coherence as pt_coh
from repro_torch.ft import runtime as pt_ft

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
N_CHAOS = 104
# every cache_pages (seed % 4), protocol (seed % 3) and program family
# (seed % 2: span programs on odd seeds) of chaos_trace_params
CHAOS_SEEDS = (tuple(range(N_CHAOS)) if FUZZ
               else (0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 14, 17))
RACE_CHAOS_SEEDS = tuple(range(24)) if FUZZ else (1, 2, 5, 7)
DRIVERS = ("batched", "loop")


def _traffic(rt):
    return dataclasses.asdict(rt.traffic)


def _same_chaos_state(pt, ref, ctx):
    """Each worker's message ticks and the global invalidation count are
    equal: every retry and invalidation was consumed as the reference
    consumed it, whether or not a drop came of it."""
    for k, v in ref.chaos.state_arrays().items():
        np.testing.assert_array_equal(pt.chaos.state_arrays()[k], v,
                                      err_msg=f"{ctx} {k}")


# ---------------------------------------------------------------------------
# (a) the fault-tolerance pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,drop,retries,cap", [
    (0, 0.05, 3, 6), (7, 0.3, 3, 6), (11, 0.6, 8, 2), (3, 0.0, 1, 0)])
def test_chaosnet_matches_reference(seed, drop, retries, cap):
    kw = dict(seed=seed, drop_rate=drop, max_retries=retries,
              backoff_cap=cap)
    ref, pt = RefChaos(**kw), PortChaos(**kw)
    st_r, st_p = {}, {}
    ref.bind(6, st_r)
    pt.bind(6, st_p)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        rows = np.sort(rng.choice(6, int(rng.integers(1, 7)), replace=False))
        np.testing.assert_array_equal(pt.retry_rows(rows),
                                      ref.retry_rows(rows))
        w = int(rng.integers(0, 6))
        assert pt.retry1(w) == ref.retry1(w)
        n = int(rng.integers(0, 40))
        pt.inval_msgs(n)
        ref.inval_msgs(n)
    assert st_p == st_r and pt.config() == ref.config()
    if drop:
        assert st_p["chaos_drops"] > 0 and st_p["chaos_inval_retries"] > 0
    for a, b in ((ref, pt), (pt, ref)):
        twin = type(b)(**a.config())
        twin.bind(6, {})
        twin.load_state(a.state_arrays())
        for k, v in a.state_arrays().items():
            assert twin.state_arrays()[k].dtype == v.dtype
            np.testing.assert_array_equal(twin.state_arrays()[k], v)
        np.testing.assert_array_equal(twin.retry_rows(np.arange(6)),
                                      a.retry_rows(np.arange(6)))
    for levels in range(5):
        assert PortChaos.backoff_seconds(5e-6, 2.0, levels, cap) == \
            RefChaos.backoff_seconds(5e-6, 2.0, levels, cap)


@pytest.mark.parametrize("seed", range(3))
def test_straggler_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    W = 5
    kw = dict(window=int(rng.integers(1, 8)), k=float(rng.uniform(1, 5)),
              abs_floor_s=1e-4, patience=int(rng.integers(1, 4)))
    ref, pt = ref_ft.StragglerMonitor(W, **kw), pt_ft.StragglerMonitor(W, **kw)
    for step in range(40):
        d = rng.exponential(1e-3, W)
        d[step % W] *= 1 + 20 * rng.random()
        assert pt.observe(d) == ref.observe(d)
        if step == 20:
            ref = ref_ft.StragglerMonitor.from_state(pt.state_arrays(),
                                                     pt.config())
            pt = pt_ft.StragglerMonitor.from_state(ref.state_arrays(),
                                                   ref.config())
    assert pt.flagged_total == ref.flagged_total > 0
    for k, v in ref.state_arrays().items():
        np.testing.assert_array_equal(pt.state_arrays()[k], v)


def test_failure_injector_and_helpers_match_reference():
    sched = [3, (5, 2), (5, 1), (7, None), 9]
    cluster = [("kill", 4, 1), ("partition_c2s", 4, 0),
               ("partition_s2c", 6, 2)]

    def fired(mod, probes):
        inj = mod.FailureInjector(at_steps=sched, cluster_at=cluster)
        out = []
        for step, worker in probes:
            try:
                inj.check(step, worker)
            except mod.WorkerFailure as e:
                out.append((e.step, e.worker, e.kind))
            out.append(tuple(inj.cluster_actions(step)))
        return out

    probes = [(s, w) for s in range(11) for w in (None, 1, 2)]
    assert fired(pt_ft, probes) == fired(ref_ft, probes)
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 30):
        xs = rng.exponential(1.0, n).tolist()
        for floor in (0.0, 0.5):
            assert pt_ft.mad_threshold(xs, 3.0, floor) == \
                ref_ft.mad_threshold(xs, 3.0, floor)
    for args in ((8, [1, 3], 100), (4, [0, 0], 10), (16, [2], 17)):
        a = pt_ft.plan_rescale(*args, spares=1)
        b = ref_ft.plan_rescale(*args, spares=1)
        assert (a.new_world, a.new_global_batch, a.local_batch,
                a.dropped_samples, a.describe()) == (
            b.new_world, b.new_global_batch, b.local_batch,
            b.dropped_samples, b.describe())


# ---------------------------------------------------------------------------
# (b) the checkpoint store
# ---------------------------------------------------------------------------


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"clock": rng.random(7), "planes": rng.random((3, 9)) < 0.5,
            "seq": rng.integers(0, 1 << 40, 7).astype(np.uint64),
            "empty": np.zeros((0, 7), np.int64)}


@pytest.mark.parametrize("writer,reader", [(pt_store, ref_store),
                                           (ref_store, pt_store)])
def test_save_and_load_arrays_across_packages(tmp_path, writer, reader):
    extra = {"config": {"backend": "pallas-jit"}, "phase_idx": 12}
    for step in (0, 3, 12):
        writer.save_arrays(tmp_path, step, _arrays(step), extra=extra)
    assert reader.latest_step(tmp_path) == 12
    got, meta = reader.load_arrays(tmp_path, 3)
    assert meta == extra
    want = _arrays(3)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


def test_checkpoint_manager_rotates_and_collects(tmp_path):
    (tmp_path / "step_000000007").mkdir()          # crash debris
    (tmp_path / "step_tmp").mkdir()                # not ours
    mgr = pt_store.CheckpointManager(tmp_path, keep=2)
    assert not (tmp_path / "step_000000007").exists()
    assert (tmp_path / "step_tmp").exists()
    for step in range(5):
        mgr.save_arrays(step, _arrays(step), extra={"step": step})
    assert mgr.latest() == 4
    kept = sorted(p.name for p in tmp_path.glob("step_0*"))
    assert kept == ["step_000000003", "step_000000004"]
    got, meta = ref_store.load_arrays(tmp_path, 4)
    assert meta == {"step": 4}
    np.testing.assert_array_equal(got["clock"], _arrays(4)["clock"])


# ---------------------------------------------------------------------------
# (c) span_all advances the phase position
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3, 5))
def test_span_all_advances_phase_idx(seed):
    """The reference ticks ``_phase_idx`` at the entry of ``phase_all``,
    ``span_all`` and ``barrier``; an injected crash lands on the event
    whose tick reaches its step, so the two must agree after every event
    of a span-bearing trace."""
    p = trace_fuzz.span_trace_params(seed)
    prog = trace_fuzz.gen_span_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["cache_pages"])
    assert any(ev[0] == "span_phase" for ev in prog)
    kw = dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
              model_mechanism=False, cache_pages=p["cache_pages"])
    ref = RefRuntime(p["W"], backend="numpy", **kw)
    pt = PortRuntime(p["W"], backend="fused", device="cpu", **kw)
    gr = [ref.alloc(p["n_words"]) for _ in range(2)]
    gp = [pt.alloc(p["n_words"]) for _ in range(2)]
    for i, ev in enumerate(prog):
        trace_fuzz.apply_event(ref, ev, gr, "batched")
        trace_fuzz.apply_event(pt, ev, gp, "batched")
        assert pt._phase_idx == ref._phase_idx, (seed, i, ev[0])


# ---------------------------------------------------------------------------
# (d) lockstep on the chaos trace family, and the harness
# ---------------------------------------------------------------------------


def _chaos_trace(seed):
    """``trace_fuzz.chaos_crosscheck``'s program and crash schedule."""
    p = trace_fuzz.chaos_trace_params(seed)
    rng = p["rng"]
    if seed % 2:
        prog = trace_fuzz.gen_span_program(rng, p["W"], p["n_words"],
                                           p["page_words"], p["cache_pages"],
                                           n_phases=5, n_regions=3)
    else:
        prog = trace_fuzz.gen_program(rng, p["W"], p["n_words"],
                                      p["page_words"], n_phases=5)
    n_crash = int(rng.integers(1, 3))
    steps = rng.choice(np.arange(1, len(prog) + 1), size=n_crash,
                       replace=False)
    at_steps = [((int(s), int(rng.integers(0, p["W"])))
                 if rng.random() < 0.5 else int(s)) for s in steps]
    return p, prog, at_steps


def _chaos_maker(p, seed, engine, **extra):
    kw = dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
              model_mechanism=False, cache_pages=p["cache_pages"], **extra)
    if engine == "ref":
        return lambda: RefRuntime(
            p["W"], backend="numpy",
            chaos=RefChaos(seed=seed, drop_rate=p["drop"]),
            straggler=ref_ft.StragglerMonitor(p["W"], window=4, patience=1),
            **kw)
    return lambda: PortRuntime(
        p["W"], backend=engine, device="cpu",
        chaos=PortChaos(seed=seed, drop_rate=p["drop"]),
        straggler=pt_ft.StragglerMonitor(p["W"], window=4, patience=1),
        **kw)


def _chaos_lockstep(seed, tiers=("plain", "fused")):
    """Returns the aggregate counters of the port's fused batched runs."""
    p, prog, at_steps = _chaos_trace(seed)
    n = p["n_words"]
    agg = {}
    for d in DRIVERS:
        ref = _chaos_maker(p, seed, "ref")()
        ports = {t: _chaos_maker(p, seed, t)() for t in tiers}
        runs = [ref, *ports.values()]
        gas = {id(rt): [rt.alloc(n) for _ in range(3)] for rt in runs}
        for i, ev in enumerate(prog):
            for rt in runs:
                if pt_coh.harness_ticks(ev, d):
                    rt.chaos_tick()
                trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
            for t, pt in ports.items():
                ctx = (seed, p["proto"], p["cache_pages"], p["drop"], t, d,
                       i, ev[0])
                assert _traffic(pt) == _traffic(ref), ctx
                np.testing.assert_allclose(pt.clock, ref.clock, rtol=0,
                                           atol=0, err_msg=str(ctx))
                assert pt._phase_idx == ref._phase_idx, ctx
                _same_chaos_state(pt, ref, ctx)
        for t, pt in ports.items():
            pt_coh.assert_bit_equal(pt, ref, (seed, t, d))
        for t in tiers:
            with tempfile.TemporaryDirectory() as td:
                inj = pt_ft.FailureInjector(at_steps=at_steps)
                rt, rep = pt_coh.ChaosHarness(
                    _chaos_maker(p, seed, t), [n, n, n], d, td,
                    trace_fuzz.apply_event, injector=inj).run(prog)
            assert rep.n_crashes == len(at_steps), (seed, t, d, rep)
            pt_coh.assert_bit_equal(rt, ports[t], (seed, t, d, "recovered"))
            if t == "fused" and d == "batched":
                agg.update(crashes=rep.n_crashes,
                           replayed_events=rep.n_replayed_events,
                           **rt.stats)
    return agg


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_trace_lockstep_and_recovery(seed):
    _chaos_lockstep(seed)


def test_chaos_sample_fires_every_path():
    """The sample crosses every chaos and engine path the reference's
    corpus asserts (``tests/test_chaos.py``): crashes with replays, drops,
    invalidation retries, straggler flags, ``span_all`` grant groups,
    batched eviction and the danger path."""
    agg = {}
    for seed in CHAOS_SEEDS:
        p, prog, at_steps = _chaos_trace(seed)
        n = p["n_words"]
        with tempfile.TemporaryDirectory() as td:
            rt, rep = pt_coh.ChaosHarness(
                _chaos_maker(p, seed, "fused"), [n, n, n], "batched", td,
                trace_fuzz.apply_event,
                injector=pt_ft.FailureInjector(at_steps=at_steps)).run(prog)
        for k, v in dict(rt.stats, crashes=rep.n_crashes,
                         replayed=rep.n_replayed_events).items():
            agg[k] = agg.get(k, 0) + v
    for k in ("crashes", "replayed", "chaos_msgs", "chaos_drops",
              "chaos_inval_retries", "straggler_checks", "straggler_flags",
              "span_all_calls", "span_groups_vec", "evict_batch_rounds",
              "danger_ops"):
        assert agg[k] > 0, (k, agg)
    assert agg["crashes"] >= len(CHAOS_SEEDS)


# traces of the other families that, under a 30% drop rate and with one
# acquire-time flush of a wide dirty range (``_wide_flush``), reach every
# retry and invalidation charge site of the engine
SITE_TRACES = (("span", 28), ("serving", 33), ("danger", 9))


def _family_trace(family, seed):
    if family == "span":
        p = trace_fuzz.span_trace_params(seed)
        return p, trace_fuzz.gen_span_program(
            p["rng"], p["W"], p["n_words"], p["page_words"],
            p["cache_pages"], n_regions=3)
    if family == "serving":
        p = trace_fuzz.serving_trace_params(seed)
        return p, trace_fuzz.gen_serving_program(
            p["rng"], p["W"], p["stride"], p["tok_words"], p["max_tokens"])
    p = trace_fuzz.danger_trace_params(seed)
    return p, trace_fuzz.gen_danger_program(
        p["rng"], p["W"], p["n_words"], p["page_words"], p["cache_pages"])


def _wide_flush(rt, ga):
    """Every worker reads 200 pages, worker 0 dirties 100 of them and
    acquires a lock: its flush invalidates the sharers' copies of more
    pages than the small-set gather takes."""
    for w in range(rt.W):
        rt.read(w, ga, 0, 16 * 200)
    rt.write(0, ga, 0, 16 * 100)
    rt.acquire(0, 5)
    rt.release(0, 5)
    rt.barrier()


def _charge_sites():
    """Source lines of ``RegCScaleRuntime`` that charge a retry or count
    lost invalidations (the helpers' own bodies and the chain's
    ``retry`` binding aside)."""
    import inspect
    import re

    from repro_torch.core import regc_scale
    lines, first = inspect.getsourcelines(regc_scale.RegCScaleRuntime)
    pat = re.compile(r"self\.chaos\.(retry1|retry_rows|inval_msgs)\(|"
                     r"\bretry\(w\)|self\._chaos_invals\(|"
                     r"self\._count_invalidations\(")
    helpers = set()
    for name in ("_chaos_invals", "_count_invalidations"):
        body, start = inspect.getsourcelines(
            getattr(regc_scale.RegCScaleRuntime, name))
        helpers.update(range(start, start + len(body)))
    return {first + i for i, line in enumerate(lines)
            if pat.search(line) and "def " not in line
            and "retry = (" not in line} - helpers


def test_chaos_reaches_every_charge_site(monkeypatch):
    """Every place the engine charges a retry or counts lost
    invalidations fires with work to do over ``SITE_TRACES`` and
    ``_wide_flush``, each run in lockstep with the reference under the
    same loss model (traffic and clocks after every event, stats at the
    end): a dropped retry term anywhere shows as a clock or counter
    difference."""
    import sys

    from repro_torch.core import regc_scale
    hit = set()
    engine = regc_scale.__file__
    real_rows, real_inval = PortChaos.retry_rows, PortChaos.inval_msgs

    def note():
        f = sys._getframe(2)
        while f.f_code.co_filename != engine or f.f_code.co_name in (
                "_chaos_invals", "_count_invalidations"):
            f = f.f_back
        hit.add(f.f_lineno)

    def retry_rows(self, rows):
        if np.size(rows):
            note()
        return real_rows(self, rows)

    def inval_msgs(self, n):
        if n > 0:
            note()
        return real_inval(self, n)

    monkeypatch.setattr(PortChaos, "retry_rows", retry_rows)
    monkeypatch.setattr(PortChaos, "inval_msgs", inval_msgs)
    for family, seed in SITE_TRACES:
        p, prog = _family_trace(family, seed)
        kw = dict(page_words=p["page_words"], protocol=p["proto"],
                  prefetch=1, model_mechanism=False,
                  cache_pages=p["cache_pages"])
        for d in DRIVERS:
            ref = RefRuntime(p["W"], backend="numpy",
                             chaos=RefChaos(seed=seed, drop_rate=0.3), **kw)
            ports = [PortRuntime(p["W"], backend=t, device="cpu",
                                 chaos=PortChaos(seed=seed, drop_rate=0.3),
                                 **kw) for t in ("plain", "fused")]
            gas = {id(rt): [rt.alloc(p["n_words"]) for _ in range(3)]
                   for rt in (ref, *ports)}
            for i, ev in enumerate(prog):
                for rt in (ref, *ports):
                    trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
                for pt in ports:
                    ctx = (family, seed, pt.backend, d, i, ev[0])
                    assert _traffic(pt) == _traffic(ref), ctx
                    np.testing.assert_allclose(pt.clock, ref.clock, rtol=0,
                                               atol=0, err_msg=str(ctx))
                    _same_chaos_state(pt, ref, ctx)
            for pt in ports:
                pt_coh.assert_bit_equal(pt, ref, (family, seed, d))
    ref = RefRuntime(3, page_words=16, chaos=RefChaos(seed=4, drop_rate=0.3))
    pt = PortRuntime(3, page_words=16, device="cpu",
                     chaos=PortChaos(seed=4, drop_rate=0.3))
    for rt in (ref, pt):
        _wide_flush(rt, rt.alloc(16 * 200))
    pt_coh.assert_bit_equal(pt, ref, "wide flush")
    _same_chaos_state(pt, ref, "wide flush")
    missed = _charge_sites() - hit
    assert not missed, sorted(missed)


@pytest.mark.parametrize("seed", RACE_CHAOS_SEEDS)
def test_race_chaos_recovery_keeps_the_race_set(seed):
    """``race_chaos_crosscheck`` on the port: crashes and barrier replay
    under race detection finish with the uninjected run's race set,
    traffic, clocks and stats, and with the reference's."""
    p = trace_fuzz.race_trace_params(seed)
    prog = trace_fuzz.gen_race_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["racy"])
    n = p["n_words"]
    kw = dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
              model_mechanism=False, cache_pages=p["cache_pages"],
              detect_races=True)
    rng = np.random.default_rng(60_000 + seed)
    at_steps = [int(s) for s in rng.choice(
        np.arange(1, len(prog) + 1), size=int(rng.integers(1, 3)),
        replace=False)]
    for d in DRIVERS:
        ref = ref_coh.run_uninjected(lambda: RefRuntime(p["W"], **kw),
                                     [n, n], d, prog, trace_fuzz.apply_event)

        def make():
            return PortRuntime(p["W"], backend="fused", device="cpu", **kw)
        base = pt_coh.run_uninjected(make, [n, n], d, prog,
                                     trace_fuzz.apply_event)
        with tempfile.TemporaryDirectory() as td:
            rt, rep = pt_coh.ChaosHarness(
                make, [n, n], d, td, trace_fuzz.apply_event,
                injector=pt_ft.FailureInjector(at_steps=at_steps)).run(prog)
        assert rep.n_crashes == len(at_steps), (seed, d)
        pt_coh.assert_bit_equal(rt, base, (seed, d))
        pt_coh.assert_bit_equal(rt, ref, (seed, d, "reference"))
        assert rt.races == base.races == ref.races, (seed, d)
        assert bool(rt.races) == p["racy"]


# ---------------------------------------------------------------------------
# (e) snapshots across the two packages
# ---------------------------------------------------------------------------


def _handoff_trace(seed):
    p, prog, _ = _chaos_trace(seed)
    cut = next(i for i in range(len(prog) // 2, len(prog))
               if prog[i][0] == "barrier") + 1
    return p, prog, cut


def _run(rt, prog, gas, driver="batched"):
    for ev in prog:
        if pt_coh.harness_ticks(ev, driver):
            rt.chaos_tick()
        trace_fuzz.apply_event(rt, ev, gas, driver)


@pytest.mark.parametrize("seed", (1, 2, 3, 7))
def test_reference_snapshot_finishes_on_the_port(seed, tmp_path):
    p, prog, cut = _handoff_trace(seed)
    n = p["n_words"]
    whole = _chaos_maker(p, seed, "ref")()
    _run(whole, prog, [whole.alloc(n) for _ in range(3)])
    ref = _chaos_maker(p, seed, "ref")()
    gas = [ref.alloc(n) for _ in range(3)]
    _run(ref, prog[:cut], gas)
    ref_coh.save_runtime(ref, tmp_path, cut)
    for backend in ("plain", "kernels", "fused"):
        pt = pt_coh.load_runtime(tmp_path, cut, backend=backend,
                                 device="cpu")
        assert pt.chaos is not None and pt.straggler is not None
        assert pt._phase_idx == ref._phase_idx and pt.stats is pt.chaos._stats
        _run(pt, prog[cut:], [pt.gas_for_region(r, n) for r in range(3)])
        pt_coh.assert_bit_equal(pt, whole, (seed, backend))


@pytest.mark.parametrize("seed", (1, 2, 3, 7))
def test_port_snapshot_finishes_on_the_reference(seed, tmp_path):
    p, prog, cut = _handoff_trace(seed)
    n = p["n_words"]
    whole = _chaos_maker(p, seed, "plain")()
    _run(whole, prog, [whole.alloc(n) for _ in range(3)])
    for backend in ("plain", "fused"):
        pt = _chaos_maker(p, seed, backend)()
        _run(pt, prog[:cut], [pt.alloc(n) for _ in range(3)])
        pt_coh.save_runtime(pt, tmp_path / backend, cut)
        arrays, meta = ref_store.load_arrays(tmp_path / backend, cut)
        assert meta["config"]["backend"] == {"plain": "numpy",
                                             "fused": "pallas-jit"}[backend]
        assert meta["config"]["n_mem_servers"] == 1
        if backend == "fused":
            # the fused tier's launches arrive as the reference's
            # jit_dispatches; run the rest on its numpy tier
            assert meta["stats"]["jit_dispatches"] == \
                pt.stats["fused_dispatches"] > 0
            meta["config"]["backend"] = "numpy"
            for dm in meta["dirs"]:
                dm["backend"] = "numpy"
        ref = RefRuntime.from_snapshot(arrays, meta)
        _run(ref, prog[cut:], [ref.gas_for_region(r, n) for r in range(3)])
        pt_coh.assert_bit_equal(ref, whole, (seed, backend))
        # and back: the port's own checkpoint restores on the port
        again = pt_coh.load_runtime(tmp_path / backend, cut, device="cpu")
        assert again.backend == backend
        _run(again, prog[cut:], [again.gas_for_region(r, n)
                                 for r in range(3)])
        pt_coh.assert_bit_equal(again, whole, (seed, backend, "port"))
        assert again.stats["fused_dispatches"] >= \
            pt.stats["fused_dispatches"]


def test_snapshot_arrays_and_meta_are_the_reference_format():
    """The same names, dtypes and shapes, and the same meta keys, as the
    reference's snapshot of the same run (race detection, a cache, chaos
    and a straggler monitor on)."""
    p, prog, cut = _handoff_trace(3)
    n = p["n_words"]
    runs = [_chaos_maker(p, 3, "ref", detect_races=True)(),
            _chaos_maker(p, 3, "fused", detect_races=True)()]
    for rt in runs:
        _run(rt, prog[:cut], [rt.alloc(n) for _ in range(3)])
    (ra, rm), (pa, pm) = (rt.snapshot() for rt in runs)
    assert pa.keys() == ra.keys()
    for k, v in ra.items():
        assert (pa[k].dtype, pa[k].shape) == (v.dtype, v.shape), k
        np.testing.assert_array_equal(pa[k], v, err_msg=k)
    assert pm.keys() == rm.keys() and pm["config"].keys() == rm[
        "config"].keys()
    for k in ("cost", "traffic", "tick", "phase_idx", "n_pages", "locks",
              "red_names", "chaos", "straggler", "region_starts"):
        assert pm[k] == rm[k], k
    assert {k: v for k, v in pm["stats"].items() if k != "jit_dispatches"} \
        == {k: v for k, v in rm["stats"].items() if k != "jit_dispatches"}
    assert [dict(m, backend=None) for m in pm["dirs"]] == \
        [dict(m, backend=None) for m in rm["dirs"]]


def test_restore_builds_device_caches_anew():
    """A restored directory derives its geometry tensors from the
    restored planes (none are carried over), and flushes as the
    original does."""
    p, prog, cut = _handoff_trace(2)
    n = p["n_words"]
    rt = _chaos_maker(p, 2, "fused")()
    gas = [rt.alloc(n) for _ in range(3)]
    _run(rt, prog[:cut], gas)
    for d in rt.dirs:
        d.jit_geometry_tensor()
    moved = PortRuntime.from_snapshot(*rt.snapshot(), device="cpu")
    for d, e in zip(rt.dirs, moved.dirs):
        assert e._jit_geom_t is None and e._cov_bounds_t is None
        assert e is not d and e.valid is not d.valid
        assert torch.equal(e.jit_geometry_tensor(), d.jit_geometry_tensor())
    _run(rt, prog[cut:], gas)
    _run(moved, prog[cut:], [moved.gas_for_region(r, n) for r in range(3)])
    pt_coh.assert_bit_equal(moved, rt)


def test_snapshot_refusals():
    rt = pt_make(3, device="cpu", page_words=16)
    ga = rt.alloc(64)
    rt.acquire(0, 1)
    with pytest.raises(RuntimeError, match="open span"):
        rt.snapshot()
    rt.release(0, 1)
    rt.reduce(0, "x", 1.0)
    with pytest.raises(RuntimeError, match="reductions"):
        rt.snapshot()
    rt.barrier()
    rt.write(1, ga, 0, 8)
    arrays, meta = rt.snapshot()
    with pytest.raises(ValueError, match="shard-slice"):
        PortRuntime.from_snapshot(arrays, dict(meta, slice=[0, 2]),
                                  device="cpu")
    pt = runtime_from_snapshot(arrays, meta, device="cpu", backend="plain")
    h = GasArray(ga.page_lo, ga.n_elems, ga.page_words)
    for r in (rt, pt):
        r.barrier()
        r.read(0, h, 0, 8)
    assert _traffic(pt) == _traffic(rt)
    np.testing.assert_array_equal(pt.clock, rt.clock)


# ---------------------------------------------------------------------------
# (f) the committed fig9 rows, through the smoke's copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("series", ("samhita", "samhita_page"))
def test_fig9_w16_rows_match_committed(series, driver, tmp_path):
    committed, meta_iters = chip_smoke.section_rows("fig9_recovery")
    iters = max(3, meta_iters // 2)
    row = committed[series, 16, driver]
    n_words = (chip_smoke.RECOVERY_PAGE_WORDS
               * chip_smoke.RECOVERY_PAGES_PER_WORKER * 16)
    prog = chip_smoke.recovery_program(16, n_words, iters)
    make = chip_smoke.recovery_maker(series, 16, "fused", "cpu")
    base = pt_coh.run_uninjected(make, [n_words], driver, prog,
                                 chip_smoke.recovery_event)
    got = {**{f"tr_{k}": v for k, v in _traffic(base).items()},
           **chip_smoke.chaos_fields(base)}
    assert got == {k: row[k] for k in got}
    assert round(base.time, 6) == row["t_model_s"]
    inj = pt_ft.FailureInjector(at_steps=[(3 * max(1, iters // 2), 8)])
    rec, rep = pt_coh.ChaosHarness(make, [n_words], driver, tmp_path,
                                   chip_smoke.recovery_event,
                                   injector=inj).run(prog)
    pt_coh.assert_bit_equal(rec, base)
    assert rep.crashed_workers == [8]
    assert {"n_events": rep.n_events, "n_checkpoints": rep.n_checkpoints,
            "n_crashes": rep.n_crashes,
            "replayed_events": rep.n_replayed_events} == \
        chip_smoke.recovery_csv()[series, 16, driver]


def test_smoke_recovery_copies_are_the_bench():
    from benchmarks import recovery as bench
    assert (chip_smoke.RECOVERY_PAGE_WORDS,
            chip_smoke.RECOVERY_PAGES_PER_WORKER, chip_smoke.RECOVERY_CORES,
            chip_smoke.RECOVERY_DROP_RATE, chip_smoke.RECOVERY_CHAOS_SEED) \
        == (bench.PAGE_WORDS, bench.PAGES_PER_WORKER, bench.CORES,
            bench.DROP_RATE, bench.CHAOS_SEED)
    for W, iters in ((4, 3), (16, 2), (7, 5)):
        n = 1024 * 4 * W
        ours = chip_smoke.recovery_program(W, n, iters)
        theirs = bench.gen_program(W, n, iters)
        assert repr(ours) == repr(theirs)
        # the same program through each executor, on each package
        pt = chip_smoke.recovery_maker("samhita", W, "fused", "cpu")()
        ref = bench.make_rt("samhita", W, page_words=1024,
                            chaos=RefChaos(seed=11, drop_rate=0.05),
                            straggler=ref_ft.StragglerMonitor(
                                W, window=4, patience=2))
        for driver, rt, run in (("loop", pt, chip_smoke.recovery_event),
                                ("loop", ref, bench.apply_event)):
            gas = [rt.alloc(n)]
            for ev in ours:
                if pt_coh.harness_ticks(ev, driver):
                    rt.chaos_tick()
                run(rt, ev, gas, driver)
        pt_coh.assert_bit_equal(pt, ref, (W, iters))
