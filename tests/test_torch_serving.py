"""The serving workload (slice F of the port) against the reference
``repro`` package, on the CPU.

* ``apps.gen_requests``: the request stream, request for request, on
  several seeds and stream shapes.
* Lockstep on ``trace_fuzz.gen_serving_program`` traces (masked admission
  spans, bursty prefill writes, windowed decode appends under slot-scale
  caches): the port's ``loop`` and ``batched`` drivers on its plain,
  kernels and fused tiers against the reference's scale engine (numpy)
  on the same driver, traffic and clocks after every event, stats at the
  end.  A sample of the 60 seeds by default (every ``cache_pages`` and
  protocol of ``serving_trace_params``); all 60 under ``FUZZ_TORCH=1``.
  The sample must reach the danger path, batched eviction and the
  admission lock's grant groups.
* ``apps.kv_serving`` at W in {3, 6, 16} against the reference (both
  drivers, every tier; the report, latencies included) and against the
  port's per-page reference engine; race-free under ``detect_races``.
* The four W=16 fig8_kv_serving rows of ``BENCH_scale.json`` through
  ``chip_smoke``'s serving point, and the smoke's copy of the bench's
  settings.

Tolerance: ``Traffic`` exact, clocks and latencies bit-equal
(``atol=0``), stats equal less the tier accounting (the reference's
``jit_*``, the port's ``fused_dispatches``); against the per-page engine
clocks within 1e-9, as the reference holds its two engines.
"""
import csv
import dataclasses
import os

import numpy as np
import pytest

import chip_smoke
import trace_fuzz
from repro.core import make_runtime as ref_make
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.dsm import apps as ref_apps
from repro_torch.core import make_runtime as pt_make
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime
from repro_torch.dsm import apps as pt_apps

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
N_SERVING = 60
# every cache_pages (seed % 4) and protocol (seed % 3) of the family
SERVING_SEEDS = (tuple(range(N_SERVING)) if FUZZ
                 else (0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 14))
PORT_TIERS = ("plain", "kernels", "fused")
DRIVERS = ("batched", "loop")
# app geometry of tests/test_kv_serving.py: 64-word pages, 8-word KV rows,
# 24-row slots (a 3-page slot stride), a cache below one prompt's pages
APP_KW = dict(tok_words=8, max_tokens=24, attn_window=8, seed=3)
RT_KW = dict(page_words=64, cache_pages=2, model_mechanism=False)


def _traffic(rt):
    return dataclasses.asdict(rt.traffic)


def _protocol_stats(stats):
    return {k: v for k, v in stats.items()
            if not k.startswith("jit_") and k != "fused_dispatches"}


def _report_key(rep):
    return (rep.steps, rep.prefill_tokens, rep.decode_tokens,
            rep.admit_spans, rep.admitted, rep.idle_slot_steps,
            rep.peak_queue,
            tuple(dataclasses.astuple(r) for r in rep.requests))


def _same_run(ref, pt, ctx):
    assert _traffic(pt) == _traffic(ref), ctx
    np.testing.assert_allclose(pt.clock, ref.clock, rtol=0, atol=0,
                               err_msg=str(ctx))


# ---------------------------------------------------------------------------
# the request stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (7, dict(n_tenants=16, burst_mean=32, gap_max=2)),
    (11, dict(n_tenants=8, zipf_s=2.0, max_tokens=40)),
    (3, dict(n_tenants=3, burst_mean=1, gap_max=5))])
def test_gen_requests_matches_reference(seed, kw):
    want = ref_apps.gen_requests(200, seed=seed, **kw)
    got = pt_apps.gen_requests(200, seed=seed, **kw)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]


# ---------------------------------------------------------------------------
# lockstep on the serving trace family
# ---------------------------------------------------------------------------


def _serving_program(seed):
    p = trace_fuzz.serving_trace_params(seed)
    prog = trace_fuzz.gen_serving_program(p["rng"], p["W"], p["stride"],
                                          p["tok_words"], p["max_tokens"])
    return p, prog


def _serving_lockstep(seed):
    """One serving trace on the reference and every port tier, both
    drivers, in lockstep; returns the port's batched fused stats."""
    p, prog = _serving_program(seed)
    kw = dict(page_words=p["page_words"], protocol=p["proto"], prefetch=1,
              model_mechanism=False, cache_pages=p["cache_pages"])
    refs = {d: RefRuntime(p["W"], backend="numpy", **kw) for d in DRIVERS}
    ports = {(t, d): PortRuntime(p["W"], backend=t, device="cpu", **kw)
             for t in PORT_TIERS for d in DRIVERS}
    runs = [(rt, d) for d, rt in refs.items()]
    runs += [(rt, d) for (_, d), rt in ports.items()]
    gas = {id(rt): [rt.alloc(p["n_words"]) for _ in range(2)]
           for rt, _ in runs}
    for i, ev in enumerate(prog):
        for rt, d in runs:
            trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
        for (tier, d), pt in ports.items():
            _same_run(refs[d], pt, (seed, p["proto"], p["cache_pages"],
                                    tier, d, i, ev[0]))
    for (tier, d), pt in ports.items():
        assert _protocol_stats(pt.stats) == \
            _protocol_stats(refs[d].stats), (seed, tier, d)
    return ports[("fused", "batched")].stats


@pytest.mark.parametrize("seed", SERVING_SEEDS)
def test_serving_trace_lockstep(seed):
    _serving_lockstep(seed)


def test_serving_sample_covers_the_family():
    """The sample spans every cache setting and protocol of the family,
    and drives the danger path, batched eviction and grant groups."""
    seen = {(trace_fuzz.serving_trace_params(s)["cache_pages"],
             trace_fuzz.serving_trace_params(s)["proto"])
            for s in SERVING_SEEDS}
    assert {c for c, _ in seen} == {2, 3, 4, None}
    assert {q for _, q in seen} == {"fine", "page", "ideal"}
    agg = {}
    for seed in SERVING_SEEDS[:8]:
        p, prog = _serving_program(seed)
        rt = PortRuntime(p["W"], page_words=p["page_words"],
                         protocol=p["proto"], prefetch=1,
                         model_mechanism=False,
                         cache_pages=p["cache_pages"], device="cpu")
        trace_fuzz.run_program(rt, prog, [rt.alloc(p["n_words"])
                                          for _ in range(2)], "batched")
        for k, v in rt.stats.items():
            agg[k] = agg.get(k, 0) + v
    for k in ("danger_vec_ops", "evict_batch_rounds", "span_all_calls",
              "span_groups_vec"):
        assert agg[k] > 0, (k, agg)
    assert agg["danger_scalar_ops"] == 0, agg


# ---------------------------------------------------------------------------
# kv_serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proto", ("fine", "page"))
@pytest.mark.parametrize("W", (3, 6, 16))
def test_kv_serving_matches_reference(W, proto):
    n_req = 3 * W
    for driver in DRIVERS:
        ref = ref_make(W, protocol=proto, **RT_KW)
        want = ref_apps.kv_serving(ref, n_req, driver=driver, **APP_KW)
        assert ref.stats["danger_vec_ops"] > 0
        for backend in PORT_TIERS:
            pt = pt_make(W, protocol=proto, backend=backend, device="cpu",
                         **RT_KW)
            got = pt_apps.kv_serving(pt, n_req, driver=driver, **APP_KW)
            ctx = (W, proto, driver, backend)
            _same_run(ref, pt, ctx)
            assert _report_key(got) == _report_key(want), ctx
            assert got.latencies().tobytes() == want.latencies().tobytes()
            assert _protocol_stats(pt.stats) == \
                _protocol_stats(ref.stats), ctx
    oracle = pt_make(W, protocol=proto, engine="reference",
                     track_values=False, device="cpu",
                     **{k: v for k, v in RT_KW.items()
                        if k != "model_mechanism"})
    got = pt_apps.kv_serving(oracle, n_req, driver="loop", **APP_KW)
    assert _traffic(oracle) == _traffic(pt), (W, proto)
    np.testing.assert_allclose(oracle.clock, pt.clock, rtol=1e-9,
                               atol=1e-12)
    assert _report_key(got)[:7] == _report_key(want)[:7]


def test_kv_serving_race_free():
    """Slot blocks are disjoint and the queue cell is lock-guarded: the
    detector flags nothing and moves neither traffic nor clocks."""
    base = pt_make(8, device="cpu", **RT_KW)
    pt_apps.kv_serving(base, 24, driver="batched", **APP_KW)
    for driver in DRIVERS:
        det = pt_make(8, device="cpu", detect_races=True, **RT_KW)
        pt_apps.kv_serving(det, 24, driver=driver, **APP_KW)
        assert not det.races and det.race_counts == {"race_ww": 0,
                                                     "race_rw": 0}
        _same_run(base, det, ("observer", driver))


# ---------------------------------------------------------------------------
# the committed fig8 rows and the smoke's copy of the bench's settings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("series", ("samhita", "samhita_page"))
def test_fig8_w16_rows_match_committed(series, driver):
    committed, _ = chip_smoke.section_rows("fig8_kv_serving")
    row = committed[series, 16, driver]
    rt, rep, _, _ = chip_smoke.run_serve_point(None, series, 16, driver,
                                               "fused", "cpu")
    got = chip_smoke.serve_fields(rt, rep)
    assert got == {k: row[k] for k in got}
    assert round(rt.time, 6) == row["t_model_s"]
    # the modeled latency figures of the committed CSV row
    name = "kv_serving" if driver == "batched" else "kv_serving_loop"
    with open(chip_smoke.ROOT / "artifacts" / "bench" / f"{name}.csv") as f:
        csv_row = next(r for r in csv.DictReader(f)
                       if r["series"] == series and r["p"] == "16")
    lat = rep.latencies()
    for q in (50, 99):
        assert round(float(np.percentile(lat, q)) * 1e3, 6) == \
            float(csv_row[f"p{q}_ms"])
    assert round(rep.tokens_per_s(), 1) == float(csv_row["tokens_per_s"])


def test_smoke_serving_settings_are_the_bench():
    from benchmarks import kv_serving as bench
    assert chip_smoke.SERVE_CORES == bench.CORES
    assert (chip_smoke.SERVE_REQ_PER_SLOT, chip_smoke.SERVE_TOK_WORDS,
            chip_smoke.SERVE_MAX_TOKENS, chip_smoke.SERVE_ATTN_WINDOW,
            chip_smoke.SERVE_CACHE_PAGES, chip_smoke.SERVE_TENANTS,
            chip_smoke.SERVE_SEED) == (
        bench.REQ_PER_SLOT, bench.TOK_WORDS, bench.MAX_TOKENS,
        bench.ATTN_WINDOW, bench.CACHE_PAGES, bench.N_TENANTS, bench.SEED)
    rt, _, _, _ = chip_smoke.run_serve_point(None, "samhita", 4, "batched",
                                             "fused", "cpu")
    ref, _, _ = bench.serve_point("samhita", 4, "batched")
    assert _traffic(rt) == _traffic(ref)
    np.testing.assert_array_equal(rt.clock, ref.clock)
