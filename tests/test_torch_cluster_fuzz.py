"""The cluster trace-fuzz family (``trace_fuzz.cluster_trace_params``) on
the port's sharded multi-process runtime, on the CPU.

Each seeded program runs sharded across 2-4 spawned shard processes
(``repro_torch.cluster``, 'fused' tier, ``device`` 'cpu'), in lockstep
with the port's single-process run: every round's cross-shard agreed
digest equals that run's state digest after the same event, and the
finish is traffic field for field, clocks bit-equal and stats equal, both
clean and under the seed's injected process faults (SIGKILL,
one-directional partitions) with the seed's degraded-mode recovery
(respawn-and-replay or rebind-to-survivor).

By default a sample of seeds that performs a kill and both partition
directions, under both recovery modes and both drivers; ``FUZZ_TORCH=1``
runs all 12 seeds with the reference suite's aggregate checks (every
fault class performed, detected and recovered; digest rounds,
checkpoints, chaos and span paths all crossed).  The port's programs,
schedules and drivers are the reference family's own
(``trace_fuzz.cluster_crosscheck``), this package in place of ``repro``.
"""
import os
import tempfile
from typing import Dict

import numpy as np
import pytest

import trace_fuzz
from repro_torch.cluster import make_runtime, state_digest
from repro_torch.ft import FailureInjector, assert_bit_equal
from repro_torch.ft.coherence import ClusterChaosHarness, harness_ticks

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
N_CLUSTER_TRACES = 12
# seed 1: a kill, then a request partition (2 shards, loop, respawn);
# seed 5: a reply partition (3 shards, loop, respawn); seed 10: a
# request partition (2 shards, batched, rebind)
SEEDS = tuple(range(N_CLUSTER_TRACES)) if FUZZ else (1, 5, 10)
RPC_TIMEOUT_S = 0.25


def port_cluster_crosscheck(seed: int) -> Dict[str, int]:
    """``trace_fuzz.cluster_crosscheck`` on the port: the seed's program
    and fault schedule, run clean and faulted through
    ``ClusterChaosHarness``, each held to the single-process run's digest
    trace and finish; returns the same aggregate counters."""
    p = trace_fuzz.cluster_trace_params(seed)
    rng = p["rng"]
    if int(rng.integers(0, 2)):
        prog = trace_fuzz.gen_span_program(rng, p["W"], p["n_words"],
                                           p["page_words"], p["cache_pages"],
                                           n_phases=4)
    else:
        prog = trace_fuzz.gen_program(rng, p["W"], p["n_words"],
                                      p["page_words"], n_phases=4)
    n = p["n_words"]
    n_faults = int(rng.integers(0, 3))
    fault_steps = rng.choice(np.arange(1, len(prog) + 1), size=n_faults,
                             replace=False)
    kinds = rng.choice(FailureInjector.CLUSTER_KINDS, size=n_faults)
    ranks = rng.integers(0, p["n_shards"], size=n_faults)
    cluster_at = [(str(k), int(s), int(r))
                  for k, s, r in zip(kinds, fault_steps, ranks)]
    cfg = dict(n_workers=p["W"], page_words=p["page_words"],
               protocol=p["proto"], cache_pages=p["cache_pages"],
               backend="fused", device="cpu",
               chaos=(dict(seed=seed, drop_rate=p["drop"])
                      if p["drop"] else None),
               straggler=dict(n_workers=p["W"], window=4, k=4.0,
                              abs_floor_s=1e-4, patience=1))
    ctx = (seed, p["proto"], p["n_shards"], p["driver"], p["recovery"])
    rt = make_runtime(cfg)
    gas = [rt.alloc(n), rt.alloc(n)]
    base_digests = {}
    for i, ev in enumerate(prog):
        if harness_ticks(ev, p["driver"]):
            rt.chaos_tick()
        trace_fuzz.apply_event(rt, ev, gas, p["driver"])
        base_digests[i] = state_digest(rt)

    stats: Dict[str, int] = {}
    with tempfile.TemporaryDirectory() as td:
        res, rep, digests = ClusterChaosHarness(
            cfg, [n, n, n], p["driver"], td, ("trace_fuzz", "apply_event"),
            n_shards=p["n_shards"], rpc_timeout_s=RPC_TIMEOUT_S).run(prog)
    assert_bit_equal(res, rt, ctx + ("clean",))
    assert res.stats == rt.stats, ctx
    assert digests == base_digests, ctx + ("lockstep",)
    assert rep.detections == 0, (ctx, rep)

    with tempfile.TemporaryDirectory() as td:
        res, rep, digests = ClusterChaosHarness(
            cfg, [n, n, n], p["driver"], td, ("trace_fuzz", "apply_event"),
            n_shards=p["n_shards"], recovery=p["recovery"],
            rpc_timeout_s=RPC_TIMEOUT_S, rpc_attempts=3,
            injector=FailureInjector(cluster_at=cluster_at)).run(prog)
    assert_bit_equal(res, rt, ctx + ("faulted",))
    assert res.stats == rt.stats, ctx
    assert digests == base_digests, ctx + ("faulted-lockstep",)
    if n_faults:
        # the earliest fault targets an alive shard: it is performed,
        # detected, and every detection traces to an injected fault
        assert rep.kills + rep.partitions >= 1, (ctx, rep)
        assert 1 <= rep.detections <= rep.kills + rep.partitions, (ctx, rep)
        if p["recovery"] == "respawn":
            assert rep.respawns == rep.detections, (ctx, rep)
        first = min(cluster_at, key=lambda t: t[1])
        stats["performed_" + first[0]] = 1
    for kind, _s, _r in cluster_at:
        stats[kind] = stats.get(kind, 0) + 1
    stats.update(rep.counters())
    stats["rpc_retries"] = rep.rpc_retries
    for k in ("chaos_msgs", "chaos_drops", "straggler_checks",
              "straggler_flags", "span_all_calls"):
        stats[k] = res.stats.get(k, 0)
    return stats


@pytest.fixture(scope="module")
def crosschecked():
    """seed -> its ``port_cluster_crosscheck`` counters, each seed run
    once for the per-seed tests and the aggregate."""
    return {}


@pytest.mark.parametrize("seed", SEEDS)
def test_port_cluster_trace_recovers_in_lockstep(seed, crosschecked):
    crosschecked[seed] = port_cluster_crosscheck(seed)


def test_port_cluster_fuzz_fault_paths_all_fire(crosschecked):
    agg: Dict[str, int] = {}
    for seed in SEEDS:
        if seed not in crosschecked:
            crosschecked[seed] = port_cluster_crosscheck(seed)
        for k, v in crosschecked[seed].items():
            agg[k] = agg.get(k, 0) + v
    # every fault class is performed (not merely scheduled), detected
    # and recovered, in both degraded modes
    assert agg["performed_kill"] > 0, agg
    assert agg["performed_partition_c2s"] > 0, agg
    assert agg["performed_partition_s2c"] > 0, agg
    assert agg["rec_kills"] > 0 and agg["rec_partitions"] > 0, agg
    assert agg["rec_detections"] >= (agg["performed_kill"]
                                     + agg["performed_partition_c2s"]
                                     + agg["performed_partition_s2c"]), agg
    assert agg["rec_respawns"] > 0 and agg["rec_rebinds"] > 0, agg
    assert agg["rec_replayed_events"] > 0, agg
    # partitions are detected by deadline and retry, never silently eaten
    assert agg["rpc_retries"] > 0, agg
    assert agg["rec_digest_rounds"] > 4 * len(SEEDS), agg
    assert agg["rec_checkpoints"] > 2 * len(SEEDS), agg
    assert agg["chaos_msgs"] > 0 and agg["chaos_drops"] > 0, agg
    assert agg["straggler_checks"] > 0 and agg["span_all_calls"] > 0, agg
