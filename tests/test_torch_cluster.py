"""The sharded multi-process cluster (slice G of the port) against the
reference ``repro`` package, on the CPU.

* ``MembershipTable`` and ``HeartbeatDetector`` give the reference's
  answers on the same call sequences (owners, alive ranks, states,
  incarnations; deadlines over seeded latency windows, equal to the
  last bit).
* ``ShardChannel`` on a fake connection, for both packages' classes:
  stale replies skipped, either partition direction driven to
  ``ShardDown`` through the deadline chain, EOF to ``ShardDown`` at
  once, an "err" reply to ``ShardError``.
* Shard-slice snapshots: ``snapshot(rows=)`` of the port equals the
  reference's array for array (name, dtype, values) and meta slice, on
  ``cluster_trace_params`` traces; ``compose_snapshots`` rebuilds the
  full snapshot; slices that do not tile raise; a raw slice is refused
  by ``from_snapshot``; a checkpoint composed by either package restores
  in the other and finishes bit-equal.
* The shard's ``make_runtime``: the tier in either vocabulary, 'fused'
  without one, the card unless the config names the CPU.
* The reference suite's seven fault scenarios on the port (``device``
  'cpu', 'fused'): clean lockstep, mid-phase SIGKILL, partition x {c2s,
  s2c} x {respawn, rebind}, shard error; for the reply partition with
  rebind, the port's ``rec_*`` counters equal the reference cluster's
  on the same program and schedule, and the two finish bit-equal.
* The committed W=16 batched ``samhita_s2`` and ``samhita_s2_fault``
  fig10_availability rows, through ``chip_smoke.cluster_phase``.

Tolerance: ``Traffic`` exact, clocks bit-equal (``atol=0``), stats
equal less the tier accounting, deadlines equal, snapshot arrays equal.
"""
import multiprocessing as mp

import numpy as np
import pytest
import torch

import chip_smoke
import trace_fuzz
from repro.cluster import ClusterRuntime as RefCluster
from repro.cluster import membership as ref_mem
from repro.cluster import rpc as ref_rpc
from repro.core.regc_scale import RegCScaleRuntime as RefRuntime
from repro.ft import FailureInjector as RefInjector
from repro_torch.cluster import (ClusterRuntime, ShardError, make_runtime,
                                 state_digest)
from repro_torch.cluster import membership as pt_mem
from repro_torch.cluster import rpc as pt_rpc
from repro_torch.core.regc_scale import RegCScaleRuntime as PortRuntime
from repro_torch.ft import FailureInjector, assert_bit_equal
from repro_torch.ft.coherence import harness_ticks
from repro_torch.kernels import protocol_sweep as ps

PACKAGES = {"port": (pt_mem, pt_rpc), "reference": (ref_mem, ref_rpc)}


# ---------------------------------------------------------------------------
# membership and failure detection, on the reference's call sequences
# ---------------------------------------------------------------------------

def _membership_trace(mem):
    """A call sequence through add, mark, rebind and reincarnate; the
    observable state after each call."""
    t = mem.MembershipTable()
    seen = []

    def note():
        seen.append((t.owners(), t.alive_ranks(),
                     {r: (rec.state.value, rec.incarnation, rec.pid,
                          rec.home_slice) for r, rec in t.records.items()}))

    for rank, (lo, hi) in enumerate([(0, 3), (3, 5), (5, 8)]):
        t.add(rank, 100 + rank, lo, hi)
        note()
    for rank in range(3):
        t.mark(rank, mem.ShardState.ALIVE)
    note()
    t.mark(1, mem.ShardState.SUSPECT)
    note()
    t.mark(1, mem.ShardState.DEAD)
    t.rebind(1, 2)
    t.mark(1, mem.ShardState.QUARANTINED)
    note()
    t.mark(2, mem.ShardState.DEAD)
    t.rebind(2, 0)
    t.mark(2, mem.ShardState.QUARANTINED)
    note()
    t.reincarnate(1, 201)
    note()
    t.mark(1, mem.ShardState.ALIVE)
    note()
    t.reincarnate(2, 202)
    t.mark(2, mem.ShardState.ALIVE)
    note()
    return seen


def test_membership_matches_reference():
    assert _membership_trace(pt_mem) == _membership_trace(ref_mem)


@pytest.mark.parametrize("floor_s,k,window,seed", [
    (0.25, 6.0, 64, 0), (0.001, 6.0, 64, 1), (0.05, 4.0, 8, 2),
    (0.5, 6.0, 16, 3)])
def test_heartbeat_detector_matches_reference(floor_s, k, window, seed):
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(np.log(0.02), 1.0, size=100)
    lat[::17] = 0.010                                # repeated values
    a = pt_mem.HeartbeatDetector(floor_s=floor_s, k=k, window=window)
    b = ref_mem.HeartbeatDetector(floor_s=floor_s, k=k, window=window)
    assert a.timeout_s() == b.timeout_s() == floor_s   # cold start
    for x in lat:
        a.observe(x)
        b.observe(x)
        assert a.timeout_s() == b.timeout_s()
        assert a.n_samples() == b.n_samples()
        assert a.timeout_s() >= floor_s


# ---------------------------------------------------------------------------
# the RPC channel on a fake connection
# ---------------------------------------------------------------------------

class _FakeConn:
    """A pipe end whose peer is scripted: ``answer(seq, op, payload)``
    returns the replies a request produces (a list of messages), or
    raises EOFError as a dead peer does."""

    def __init__(self, answer):
        self.answer = answer
        self.sent = []
        self.inbox = []

    def send(self, msg):
        self.sent.append(msg)
        self.inbox.extend(self.answer(*msg))

    def poll(self, timeout):
        return bool(self.inbox)

    def recv(self):
        if not self.inbox:
            raise EOFError
        msg = self.inbox.pop(0)
        if isinstance(msg, BaseException):
            raise msg
        return msg

    def close(self):
        pass


@pytest.mark.parametrize("pkg", PACKAGES)
def test_channel_skips_stale_replies(pkg):
    _mem, rpc = PACKAGES[pkg]
    conn = _FakeConn(lambda seq, op, p: [(seq - 1, "ok", "old"),
                                         (seq + 7, "ok", "other"),
                                         (seq, "ok", p * 2)])
    ch = rpc.ShardChannel(conn, 3)
    assert ch.request("apply", 21, timeout_s=0.01) == (42, 0)
    assert ch.request("apply", 5, timeout_s=0.01) == (10, 0)
    assert [m[0] for m in conn.sent] == [1, 2]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("direction", ["drop_c2s", "drop_s2c"])
def test_channel_partition_exhausts_the_deadline_chain(pkg, direction):
    _mem, rpc = PACKAGES[pkg]
    conn = _FakeConn(lambda seq, op, p: [(seq, "ok", p)])
    ch = rpc.ShardChannel(conn, 1)
    assert ch.request("ping", 1, timeout_s=0.01) == (1, 0)
    setattr(ch, direction, True)
    retries = []
    with pytest.raises(rpc.ShardDown, match="deadline after 3 attempts"):
        ch.request("ping", 2, timeout_s=0.002, attempts=3, backoff=2.0,
                   on_retry=retries.append)
    assert retries == [0, 1, 2]
    # c2s: the shard never hears the request; s2c: it hears every re-send
    # and answers, and the partition eats each reply
    assert len(conn.sent) == (1 if direction == "drop_c2s" else 4)
    assert conn.inbox == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_channel_eof_is_shard_down_at_once(pkg):
    _mem, rpc = PACKAGES[pkg]
    conn = _FakeConn(lambda seq, op, p: [EOFError()])
    ch = rpc.ShardChannel(conn, 2)
    with pytest.raises(rpc.ShardDown, match="pipe closed on recv") as e:
        ch.request("apply", 0, timeout_s=60.0, attempts=4)
    assert e.value.rank == 2
    assert len(conn.sent) == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_channel_err_reply_is_shard_error(pkg):
    _mem, rpc = PACKAGES[pkg]
    conn = _FakeConn(lambda seq, op, p: [(seq, "err", "Traceback: boom")])
    ch = rpc.ShardChannel(conn, 0)
    with pytest.raises(rpc.ShardError, match="boom"):
        ch.request("apply", 0, timeout_s=0.01, attempts=4)
    assert len(conn.sent) == 1          # an error is never retried


# ---------------------------------------------------------------------------
# shard-slice snapshots
# ---------------------------------------------------------------------------

def _run_pair(seed):
    """A ``cluster_trace_params`` span trace (with race detection on odd
    seeds) run on the reference and on the port's plain tier."""
    p = trace_fuzz.cluster_trace_params(seed)
    kw = dict(page_words=p["page_words"], protocol=p["proto"],
              cache_pages=p["cache_pages"], detect_races=bool(seed % 2))
    ref = RefRuntime(p["W"], **kw)
    pt = PortRuntime(p["W"], backend="plain", device="cpu", **kw)
    prog = trace_fuzz.gen_span_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["cache_pages"],
                                       n_phases=4)
    gr = [ref.alloc(p["n_words"]), ref.alloc(p["n_words"])]
    gp = [pt.alloc(p["n_words"]), pt.alloc(p["n_words"])]
    cut = max(i for i, ev in enumerate(prog) if ev[0] == "barrier") + 1
    for ev in prog[:cut]:
        trace_fuzz.apply_event(ref, ev, gr, "batched")
        trace_fuzz.apply_event(pt, ev, gp, "batched")
    return ref, pt, p, prog, cut


def _same_arrays(a, b, ctx):
    assert set(a) == set(b), (ctx, set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype, (ctx, k, a[k].dtype, b[k].dtype)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("seed", range(6))
def test_snapshot_slices_match_reference(seed):
    ref, pt, p, _prog, _cut = _run_pair(seed)
    W = p["W"]
    for rows in ((0, W // 2), (W // 2, W), (1, W), (0, W), (W - 1, W)):
        ra, rm = ref.snapshot(rows=rows)
        pa, pm = pt.snapshot(rows=rows)
        _same_arrays(pa, ra, (seed, rows))
        assert pm["slice"] == rm["slice"] == list(rows)
        assert pm["config"] == rm["config"]
        assert pm["dirs"] == rm["dirs"]


@pytest.mark.parametrize("seed", range(3))
def test_compose_snapshots_round_trip(seed):
    _ref, pt, p, prog, cut = _run_pair(seed)
    W = p["W"]
    full, full_meta = pt.snapshot()
    bounds = np.linspace(0, W, min(W, 3) + 1).astype(int)
    parts = [pt.snapshot(rows=(int(lo), int(hi)))
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    arrays, meta = PortRuntime.compose_snapshots(parts[::-1])
    assert meta == full_meta
    _same_arrays(arrays, full, seed)
    again = PortRuntime.from_snapshot(arrays, meta, device="cpu")
    assert_bit_equal(again, pt, seed)
    with pytest.raises(ValueError, match="shard-slice"):
        PortRuntime.from_snapshot(*parts[0], device="cpu")


def test_slices_that_do_not_tile_raise():
    _ref, pt, p, _prog, _cut = _run_pair(2)
    W = p["W"]
    with pytest.raises(ValueError, match="gap before 2"):
        PortRuntime.compose_snapshots([pt.snapshot(rows=(0, 1)),
                                       pt.snapshot(rows=(2, W))])
    with pytest.raises(ValueError, match=f"cover \\[0, {W - 1}\\)"):
        PortRuntime.compose_snapshots([pt.snapshot(rows=(0, W - 1))])
    with pytest.raises(ValueError, match="outside"):
        pt.snapshot(rows=(1, 1))
    # replicas that disagree on a global do not compose
    a, m = pt.snapshot(rows=(0, 1))
    b, n = pt.snapshot(rows=(1, W))
    b = dict(b, red_vals=b["red_vals"] + 1.0)
    if b["red_vals"].size:
        with pytest.raises(ValueError, match="red_vals"):
            PortRuntime.compose_snapshots([(a, m), (b, n)])
    n = dict(n, tick=n["tick"] + 1)
    with pytest.raises(ValueError, match="metas diverged"):
        PortRuntime.compose_snapshots([(a, m), (pt.snapshot(rows=(1, W))[0],
                                                n)])


@pytest.mark.parametrize("seed", (0, 1, 4))
def test_composed_checkpoints_restore_across_packages(seed):
    """A checkpoint composed by the port restores in the reference, and
    one composed by the reference restores in the port; each goes on
    with the rest of the trace and finishes bit-equal to the run that
    never stopped."""
    ref, pt, p, prog, cut = _run_pair(seed)
    W, n = p["W"], p["n_words"]
    halves = ((0, W // 2), (W // 2, W))
    from_port = PortRuntime.compose_snapshots(
        [pt.snapshot(rows=r) for r in halves])
    from_ref = RefRuntime.compose_snapshots(
        [ref.snapshot(rows=r) for r in halves])
    on_ref = RefRuntime.from_snapshot(*from_port)
    on_port = PortRuntime.from_snapshot(*from_ref, device="cpu")
    assert on_port.backend == "plain"
    for rt in (ref, pt, on_ref, on_port):
        gas = [rt.gas_for_region(r, n) for r in range(2)]
        for ev in prog[cut:]:
            trace_fuzz.apply_event(rt, ev, gas, "batched")
    for rt in (pt, on_ref, on_port):
        assert_bit_equal(rt, ref, seed)
    if ref.detect_races:
        assert on_port.races == on_ref.races == ref.races


# ---------------------------------------------------------------------------
# the shard's runtime factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,tier", [
    (None, "fused"), ("numpy", "plain"), ("pallas", "kernels"),
    ("pallas-jit", "fused"), ("plain", "plain"), ("kernels", "kernels"),
    ("fused", "fused")])
def test_shard_make_runtime_reads_either_vocabulary(backend, tier):
    cfg = dict(n_workers=4, page_words=16, protocol="fine", device="cpu")
    if backend is not None:
        cfg["backend"] = backend
    rt = make_runtime(cfg)
    assert (rt.backend, rt.device.type) == (tier, "cpu")


def test_shard_make_runtime_defaults_to_the_card():
    cfg = dict(n_workers=4, page_words=16, protocol="fine",
               chaos=dict(seed=1, drop_rate=0.1),
               straggler=dict(n_workers=4, window=4, k=4.0,
                              abs_floor_s=1e-4, patience=2))
    if torch.cuda.is_available():
        assert make_runtime(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_runtime(cfg)
    rt = make_runtime(dict(cfg, device="cpu"))
    assert rt.chaos is not None and rt.straggler is not None


# ---------------------------------------------------------------------------
# the reference suite's fault scenarios, on the port
# ---------------------------------------------------------------------------

_W = 4
_PAGE = 16
_NW = _PAGE * 30
_APPLY = ("trace_fuzz", "apply_event")


def _cfg(**kw):
    return dict(n_workers=_W, page_words=_PAGE, protocol="fine",
                cache_pages=6, chaos=dict(seed=3, drop_rate=0.1),
                straggler=None, **kw)


def _prog():
    rng = np.random.default_rng(1)
    return trace_fuzz.gen_span_program(rng, _W, _NW, _PAGE, 6, n_phases=6)


def _baseline(prog):
    """The single-process run on the port, with its per-event digests."""
    rt = make_runtime(_cfg(backend="fused", device="cpu"))
    gas = [rt.alloc(_NW), rt.alloc(_NW // 2)]
    digests = {}
    for i, ev in enumerate(prog):
        if harness_ticks(ev, "batched"):
            rt.chaos_tick()
        trace_fuzz.apply_event(rt, ev, gas, "batched")
        digests[i] = state_digest(rt)
    return rt, digests


def _cluster(prog, root, injector=None, recovery="respawn"):
    with ClusterRuntime(_cfg(backend="fused", device="cpu"),
                        [_NW, _NW // 2], n_shards=2, driver="batched",
                        apply_ref=_APPLY, root=root, injector=injector,
                        recovery=recovery, rpc_timeout_s=0.25,
                        rpc_attempts=3) as cl:
        res = cl.run(prog)
        return res, dict(cl.digests)


def test_cluster_clean_lockstep(tmp_path):
    prog = _prog()
    base, digests = _baseline(prog)
    res, got = _cluster(prog, tmp_path)
    assert_bit_equal(res, base, "clean")
    assert res.stats["fused_dispatches"] == base.stats["fused_dispatches"]
    assert res.report.detections == 0
    assert res.report.digest_rounds == len(prog)
    assert got == digests
    assert res.devices == {0: "cpu", 1: "cpu"}
    # a CPU run launches nothing: the kernels' plain versions ran
    assert sum(res.launches.values()) == 0
    assert set(res.launches) == set(ps.LAUNCHES)


def test_cluster_sigkill_midphase_recovers_bit_equal(tmp_path):
    """SIGKILL a shard between two phase events (mid-phase, not at a
    barrier): quarantine, respawn from the last barrier checkpoint,
    replay the suffix, finish bit-equal and in lockstep."""
    prog = _prog()
    base, digests = _baseline(prog)
    inj = FailureInjector(cluster_at=[("kill", 5, 1)])
    res, got = _cluster(prog, tmp_path, injector=inj)
    assert_bit_equal(res, base, "kill")
    assert got == digests
    c = res.report.counters()
    assert c["rec_kills"] == 1 and c["rec_detections"] == 1, c
    assert c["rec_respawns"] == 1 and c["rec_replayed_events"] > 0, c


@pytest.mark.parametrize("direction", ["partition_c2s", "partition_s2c"])
@pytest.mark.parametrize("mode", ["respawn", "rebind"])
def test_cluster_partition_one_direction_recovers(tmp_path, direction,
                                                  mode):
    """A one-directional link partition must be detected by deadline and
    backoff-retry exhaustion, the partitioned-but-healthy process fenced,
    and the run recovered bit-equal in both degraded modes."""
    prog = _prog()
    base, digests = _baseline(prog)
    inj = FailureInjector(cluster_at=[(direction, 7, 0)])
    res, got = _cluster(prog, tmp_path / "port", injector=inj,
                        recovery=mode)
    assert_bit_equal(res, base, (direction, mode))
    assert got == digests
    c = res.report.counters()
    assert c["rec_partitions"] == 1 and c["rec_detections"] == 1, c
    assert res.report.rpc_retries >= 2, res.report
    if mode == "rebind":
        assert c["rec_rebinds"] == 1 and c["rec_respawns"] == 0, c
        assert list(res.devices) == [1]
    else:
        assert c["rec_respawns"] == 1, c
    if (direction, mode) == ("partition_s2c", "rebind"):
        # the reference cluster on the same program and schedule
        with RefCluster(_cfg(), [_NW, _NW // 2], n_shards=2,
                        driver="batched", apply_ref=_APPLY,
                        root=tmp_path / "ref",
                        injector=RefInjector(cluster_at=[(direction, 7, 0)]),
                        recovery=mode, rpc_timeout_s=0.25,
                        rpc_attempts=3) as cl:
            ref = cl.run(prog)
        assert c == ref.report.counters()
        assert_bit_equal(res, ref, "port vs reference cluster")


def test_cluster_shard_error_propagates(tmp_path):
    """A shard-side exception (not a death) surfaces as ShardError with
    the remote traceback, never swallowed or retried, and every shard
    process is stopped."""
    before = set(mp.active_children())
    with pytest.raises(ShardError, match="ValueError"):
        _cluster([("phase",)], tmp_path)      # malformed: unpack raises
    assert set(mp.active_children()) <= before


# ---------------------------------------------------------------------------
# the committed fig10_availability rows
# ---------------------------------------------------------------------------

def test_committed_availability_rows_w16():
    """``samhita_s2`` and ``samhita_s2_fault`` at W=16, batched, on the
    port's 'fused' tier on the CPU: equal to their ``BENCH_scale.json``
    rows (``t_model_s``, ``tr_*``, ``rec_*``, chaos and straggler
    counters), bit-equal to the single-process run and in lockstep."""
    rows, launches = chip_smoke.cluster_phase(
        torch, ps, "cpu", device="cpu", groups=((16, "batched"),),
        shards=(2,))
    assert [r["series"] for r in rows] == ["samhita_s2", "samhita_s2_fault"]
    clean, fault = rows
    assert clean["rec_detections"] == 0 and clean["rec_checkpoints"] == 4
    assert (fault["rec_kills"], fault["rec_partitions"],
            fault["rec_respawns"], fault["rec_replayed_events"]) == (1, 1,
                                                                    2, 2)
    assert sum(launches.values()) == 0
