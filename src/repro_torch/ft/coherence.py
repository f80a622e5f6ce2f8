"""Fault tolerance for the RegC coherence engine: barrier-consistent
checkpoints, chaos-driven crash recovery, and the exactness bar.

Region and barrier boundaries are the only points where coherence state
is globally reconciled (the paper's rules 2-3), which makes them
consistent cuts: at a barrier every span is closed, every reduction
resolved, every dirty page flushed and every lock log replayed.
``RegCScaleRuntime.snapshot()`` serializes the complete protocol state
at such a cut (the directory planes come back from the device once);
this module writes it to the npz-shard + atomic-manifest store and runs
the crash-recovery lockstep:

    run with failures -> crash -> restore the last barrier checkpoint ->
    replay the suffix -> traffic field for field and clocks bit-equal
    with the run that never failed.

The replay is exact: message loss (``dsm.costmodel.ChaosNet``) is a
function of each worker's own event counters, which the checkpoint
holds, so the replayed suffix meets the same drops and retry charges as
the uninjected run.  Snapshots use the reference package's format, so a
checkpoint either package wrote restores in the other.
``ClusterChaosHarness`` holds the sharded multi-process runtime
(``repro_torch.cluster``) to the same bar under process faults.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.checkpoint.store import load_arrays, save_arrays
from repro_torch.core.regc import Traffic
from repro_torch.core.regc_scale import RegCScaleRuntime
from repro_torch.ft.runtime import WorkerFailure


def save_runtime(rt: RegCScaleRuntime, root, step: int):
    """Checkpoint a runtime at a barrier-consistent cut (``step`` is the
    caller's resume cursor, e.g. the index of the next program event)."""
    arrays, meta = rt.snapshot()
    save_arrays(root, step, arrays, extra=meta)


def load_runtime(root, step: int, *, injector=None, backend=None,
                 device=None) -> RegCScaleRuntime:
    """Rebuild a bit-identical runtime from a :func:`save_runtime`
    checkpoint (either package's) on ``device``, on the checkpoint's tier
    unless ``backend`` names another.  ``injector`` (typically the same,
    partly fired FailureInjector) rearms crash injection on the replayed
    suffix."""
    arrays, meta = load_arrays(root, step)
    return RegCScaleRuntime.from_snapshot(arrays, meta, injector=injector,
                                          backend=backend, device=device)


def harness_ticks(ev, driver: str) -> bool:
    """Whether the harness must call ``rt.chaos_tick()`` for this event.

    The batched driver's bulk entry points (``phase_all``/``span_all``)
    and ``barrier`` (both drivers) tick internally; per-worker loop
    events have no single runtime entry, so the harness ticks once per
    event, giving both drivers the same per-event injection schedule."""
    kind = ev[0]
    if kind == "barrier":
        return False
    if driver == "batched":
        return kind not in ("phase", "span_phase")
    return True


@dataclasses.dataclass
class RecoveryReport:
    """What a :class:`ChaosHarness` run went through."""

    n_events: int = 0
    n_crashes: int = 0
    n_checkpoints: int = 0
    n_replayed_events: int = 0
    crashed_workers: List[int] = dataclasses.field(default_factory=list)


class ChaosHarness:
    """Run a phase program under failure injection with
    checkpoint-at-barrier recovery.

    ``make_rt`` builds a fresh runtime (chaos / straggler attached);
    region handles are rebuilt through ``gas_for_region`` after a
    restore.  On ``WorkerFailure`` the harness restores the LAST barrier
    checkpoint onto the crashed runtime's device and tier, reattaching
    the same (now partly fired) injector so a configured crash fires
    once, and resumes from the checkpointed event cursor.
    ``apply_event(rt, ev, gas, driver)`` executes one program event."""

    def __init__(self, make_rt: Callable[[], RegCScaleRuntime],
                 gas_words: Sequence[int], driver: str, root,
                 apply_event: Callable, *, injector=None):
        self.make_rt = make_rt
        self.gas_words = list(gas_words)
        self.driver = driver
        self.root = root
        self.apply_event = apply_event
        self.injector = injector

    def run(self, prog) -> "tuple[RegCScaleRuntime, RecoveryReport]":
        rep = RecoveryReport(n_events=len(prog))
        rt = self.make_rt()
        rt.injector = self.injector
        gas = [rt.alloc(n) for n in self.gas_words]
        save_runtime(rt, self.root, 0)          # the t=0 cut
        rep.n_checkpoints += 1
        last_ckpt = 0
        i = 0
        while i < len(prog):
            ev = prog[i]
            try:
                if harness_ticks(ev, self.driver):
                    rt.chaos_tick()
                self.apply_event(rt, ev, gas, self.driver)
            except WorkerFailure as e:
                rep.n_crashes += 1
                rep.crashed_workers.append(e.worker)
                rep.n_replayed_events += i - last_ckpt
                rt = load_runtime(self.root, last_ckpt,
                                  injector=self.injector,
                                  backend=rt.backend, device=rt.device)
                gas = [rt.gas_for_region(r, n)
                       for r, n in enumerate(self.gas_words)]
                i = last_ckpt
                continue
            i += 1
            if ev[0] == "barrier":
                # the post-barrier state is a consistent cut; the cursor
                # is the next event, so recovery replays exactly the suffix
                save_runtime(rt, self.root, i)
                rep.n_checkpoints += 1
                last_ckpt = i
        return rt, rep


class ClusterChaosHarness:
    """:class:`ChaosHarness`'s process-level sibling: run a trace program
    on the sharded multi-process runtime (``repro_torch.cluster``) under
    *process* faults (SIGKILL and one-directional link partitions from
    ``FailureInjector.cluster_at``) with the same contract: recover
    through the last barrier checkpoint and finish traffic field for
    field and clock bit-equal to the unfailed single-process run.  The
    control plane performs detection, quarantine and re-sharding itself;
    this wrapper gives the construct-run-report shape and keeps
    ``repro_torch.cluster`` a lazy import."""

    def __init__(self, cfg: dict, gas_words: Sequence[int], driver: str,
                 root, apply_ref: "tuple[str, str]", *, n_shards: int,
                 injector=None, recovery: str = "respawn",
                 rpc_timeout_s: float = 0.25, rpc_attempts: int = 4):
        self.cfg = dict(cfg)
        self.gas_words = list(gas_words)
        self.driver = driver
        self.root = root
        self.apply_ref = tuple(apply_ref)
        self.n_shards = int(n_shards)
        self.injector = injector
        self.recovery = recovery
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.rpc_attempts = int(rpc_attempts)

    def run(self, prog):
        """Returns ``(ClusterResult, ClusterReport, digests)`` where
        ``digests`` maps event index -> the digest every shard agreed
        on (the lockstep trace a single-process run must reproduce)."""
        from repro_torch.cluster.control import ClusterRuntime
        with ClusterRuntime(self.cfg, self.gas_words,
                            n_shards=self.n_shards, driver=self.driver,
                            apply_ref=self.apply_ref, root=self.root,
                            recovery=self.recovery,
                            injector=self.injector,
                            rpc_timeout_s=self.rpc_timeout_s,
                            rpc_attempts=self.rpc_attempts) as cluster:
            result = cluster.run(prog)
            return result, result.report, dict(cluster.digests)


def run_uninjected(make_rt: Callable[[], RegCScaleRuntime],
                   gas_words: Sequence[int], driver: str, prog,
                   apply_event: Callable) -> RegCScaleRuntime:
    """The no-failure baseline a recovered run must match bit for bit,
    ticking the same per-event schedule as :class:`ChaosHarness`."""
    rt = make_rt()
    gas = [rt.alloc(n) for n in gas_words]
    for ev in prog:
        if harness_ticks(ev, driver):
            rt.chaos_tick()
        apply_event(rt, ev, gas, driver)
    return rt


def _protocol_stats(stats: dict) -> dict:
    # tier accounting (the reference's jit_* counters, this package's
    # fused_dispatches) counts device dispatches, not protocol state
    return {k: v for k, v in stats.items()
            if not k.startswith("jit_") and k != "fused_dispatches"}


def assert_bit_equal(a, b, ctx=""):
    """The recovery exactness bar: traffic field for field, clocks
    bit-equal, stats identical but for the tier accounting.  Either
    runtime may be the reference package's."""
    for f in dataclasses.fields(Traffic):
        av, bv = getattr(a.traffic, f.name), getattr(b.traffic, f.name)
        assert av == bv, (ctx, f.name, av, bv)
    np.testing.assert_array_equal(a.clock, b.clock, err_msg=str(ctx))
    sa, sb = _protocol_stats(a.stats), _protocol_stats(b.stats)
    assert sa == sb, (ctx, sa, sb)
