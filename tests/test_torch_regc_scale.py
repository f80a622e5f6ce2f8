"""Slice-level parity of the port's RegC engine
(``repro_torch.core.regc_scale``) against the reference
``repro.core.regc_scale.RegCScaleRuntime``, in lockstep.

Traces come from ``tests/trace_fuzz.gen_program`` with ``trace_params``
seeds = 0 mod 4 (``cache_pages=None``: the slice has no spill), which
cycle the fine/page/ideal protocols and include per-worker ``spans``
events.  Each trace runs, event by event, on the port (``device="cpu"``;
plain/kernels/fused tiers x batched/loop drivers) and on the reference
(numpy tier, both drivers; pallas-jit, batched), with ``model_mechanism``
on and off.  After every event:

* ``Traffic`` equal field for field (exact);
* per-worker clocks bit-equal (``atol=0``: the port charges on the host in
  float64 in the reference's order of operations);
* ``stats`` equal except the reference's ``jit_*`` accounting and the
  port's ``fused_dispatches``; the port's fused-tier dispatch count (one
  ``phase_step`` per flush) equals the reference's pallas-jit
  ``jit_dispatches``.

A sample of 12 seeds runs by default; ``FUZZ_TORCH=1`` runs all 55 seeds
= 0 mod 4 of the reference's 220-trace corpus.  A mid-trace handoff
through ``runtime_from_snapshot`` must finish bit-equal as well.
"""
import dataclasses
import os

import numpy as np
import pytest

import trace_fuzz
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.kernels import protocol_sweep as ref_ps
from repro_torch.core import GasArray, runtime_from_snapshot
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime

N_TRACES = 220
SEEDS = (tuple(range(0, N_TRACES, 4)) if os.environ.get("FUZZ_TORCH") == "1"
         else (0, 4, 8, 20, 36, 52, 88, 100, 136, 164, 192, 216))
PORT_TIERS = ("plain", "kernels", "fused")
DRIVERS = ("batched", "loop")


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


def _traffic(rt):
    return dataclasses.asdict(rt.traffic)


def _stats(rt):
    return {k: v for k, v in rt.stats.items()
            if not k.startswith("jit_") and k != "fused_dispatches"}


def _program(seed):
    p = trace_fuzz.trace_params(seed)
    assert p["cache_pages"] is None
    prog = trace_fuzz.gen_program(p["rng"], p["W"], p["n_words"],
                                  p["page_words"])
    return p, prog


def _ref(p, backend, mech):
    return RefRuntime(p["W"], page_words=p["page_words"],
                      protocol=p["proto"], prefetch=1,
                      model_mechanism=mech, backend=backend)


def _port(p, backend, mech):
    return PortRuntime(p["W"], page_words=p["page_words"],
                       protocol=p["proto"], prefetch=1,
                       model_mechanism=mech, backend=backend, device="cpu")


def _assert_match(ref, pt, ctx):
    assert _traffic(pt) == _traffic(ref), ctx
    np.testing.assert_allclose(pt.clock, ref.clock, rtol=0, atol=0,
                               err_msg=str(ctx))
    assert _stats(pt) == _stats(ref), ctx


@pytest.mark.parametrize("mech", (True, False), ids=("mech", "nomech"))
@pytest.mark.parametrize("seed", SEEDS)
def test_lockstep_gen_program(seed, mech):
    p, prog = _program(seed)
    n_alloc = p["n_words"]
    refs = {d: _ref(p, "numpy", mech) for d in DRIVERS}
    jit = _ref(p, "pallas-jit", mech)
    ports = {(t, d): _port(p, t, mech) for t in PORT_TIERS for d in DRIVERS}
    runs = [(rt, d) for d, rt in refs.items()] + [(jit, "batched")]
    runs += [(rt, d) for (_, d), rt in ports.items()]
    gas = {id(rt): [rt.alloc(n_alloc) for _ in range(2)] for rt, _ in runs}
    for i, ev in enumerate(prog):
        for rt, d in runs:
            trace_fuzz.apply_event(rt, ev, gas[id(rt)], d)
        for (tier, d), pt in ports.items():
            ctx = (seed, p["proto"], mech, tier, d, i, ev[0])
            _assert_match(refs[d], pt, ctx)
            if tier == "fused":
                assert (pt.stats["fused_dispatches"]
                        == jit.stats["jit_dispatches"]), ctx
        np.testing.assert_allclose(jit.clock, refs["batched"].clock,
                                   rtol=0, atol=0)
    # the trace really flushed through the fused tier's kernel (IDEAL
    # skips sharer work and so the fused chain)
    if p["proto"] != "ideal":
        assert ports[("fused", "batched")].stats["fused_dispatches"] > 0


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_snapshot_handoff_finishes_bit_equal(seed):
    """Run the reference for half a trace, carry its snapshot into the
    port, then run the second half on both: equal traffic and stats,
    bit-equal clocks, after every event of the second half."""
    p, prog = _program(seed)
    cut = len(prog) // 2
    ref = _ref(p, "numpy", True)
    gas_r = [ref.alloc(p["n_words"]) for _ in range(2)]
    for ev in prog[:cut]:
        trace_fuzz.apply_event(ref, ev, gas_r, "batched")
    arrays, meta = ref.snapshot()
    for backend in PORT_TIERS:
        pt = runtime_from_snapshot(arrays, meta, device="cpu",
                                   backend=backend)
        _assert_match(ref, pt, (seed, backend, "handoff"))
        gas_p = [GasArray(g.page_lo, g.n_elems, g.page_words) for g in gas_r]
        # the reference goes on from the same snapshot
        twin = RefRuntime.from_snapshot(arrays, meta)
        gas_t = [twin.gas_for_region(r, p["n_words"]) for r in range(2)]
        for i, ev in enumerate(prog[cut:]):
            trace_fuzz.apply_event(twin, ev, gas_t, "batched")
            trace_fuzz.apply_event(pt, ev, gas_p, "batched")
            _assert_match(twin, pt, (seed, backend, cut + i, ev[0]))


def test_snapshot_outside_the_slice_is_refused():
    """A raw shard slice of a snapshot (``snapshot(rows=)``) is refused,
    as the reference refuses it; the snapshot ``compose_snapshots``
    builds from the slices restores (``test_torch_cluster.py``).
    Race-detection state carries over (more in ``test_torch_race.py``),
    as does eviction state (``test_torch_evict.py``)."""
    rt = RefRuntime(3, page_words=16, detect_races=True)
    ga = rt.alloc(200)
    rt.phase_all(reads=[(ga, np.zeros(3, np.int64),
                         np.full(3, 200, np.int64))])
    rt.phase_all(writes=[(ga, np.zeros(3, np.int64),
                          np.full(3, 20, np.int64))])
    arrays, meta = rt.snapshot()
    pt = runtime_from_snapshot(arrays, meta, device="cpu")
    assert pt.detect_races and pt.races == rt.races and rt.races
    np.testing.assert_array_equal(pt.race_vc, rt.race_vc)
    np.testing.assert_array_equal(pt.dirs[0].race_w.numpy(),
                                  rt.dirs[0].race_w)
    rt = RefRuntime(3, page_words=16, cache_pages=4)
    arrays, meta = rt.snapshot(rows=(0, 2))
    with pytest.raises(ValueError, match="shard-slice"):
        runtime_from_snapshot(arrays, meta, device="cpu")
