"""The cluster control plane: membership, rounds, checkpoints, recovery.

``ClusterRuntime`` fronts N spawned shard processes (``shard.py``) and
drives a trace program round by round:

* **Rounds.**  Each event is broadcast to every alive shard, then acks
  are collected under the heartbeat-adaptive deadline chain
  (``membership.HeartbeatDetector`` + ``rpc.ShardChannel``).  Every ack
  carries a state digest; a fully-acked round asserts all replicas
  agree bit for bit before advancing.
* **Checkpoints.**  After every barrier event the control plane pulls
  each owner's ``snapshot(rows=slice)``, reassembles them with
  ``RegCScaleRuntime.compose_snapshots`` (which re-checks replicated-
  global agreement) and commits the composed snapshot through the
  crash-durable checkpoint store.  The checkpoint cursor is the index of
  the next event, exactly like ``ft.coherence.ChaosHarness``.
* **Failure + recovery.**  A dead pipe or an exhausted deadline chain
  marks the shard DEAD; the control plane *fences* it (SIGKILL: a
  partitioned-but-healthy process must not keep running), quarantines
  it, and recovers in one of two degraded modes:

    - ``respawn``: start a replacement process, restore the last barrier
      checkpoint into it, replay the suffix up to (excluding) the
      current round, then retry the round; event-index dedup makes the
      retry idempotent for survivors.
    - ``rebind``: hand the dead rank's worker slice to a survivor
      (instant, capacity-degraded; replicas make this free), falling
      back to ``respawn`` when nobody survived.

  Either way the finish is traffic field for field and clock bit-equal
  to the unfailed single-process run.

Shards are started with the ``spawn`` method: on the card each owns CUDA
tensors, and ``fork`` after CUDA init is unsafe.  All ranks' processes
start first and then take their ``init`` in rank order, so that their
interpreter and ``import torch`` costs overlap; rank order, membership
and every ``rec_*`` counter are those of one-at-a-time starts.

Real RPC wall time (retries, deadlines) never touches the modeled
clocks; it is accounted in the :class:`ClusterReport` through
``ChaosNet.backoff_seconds``, the same capped backoff term the in-model
loss tier charges.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.store import load_arrays, save_arrays
from repro_torch.cluster.membership import (HeartbeatDetector,
                                            MembershipTable, ShardState)
from repro_torch.cluster.rpc import ShardChannel, ShardDown
from repro_torch.cluster.shard import shard_main
from repro_torch.core.regc import Traffic
from repro_torch.core.regc_scale import RegCScaleRuntime
from repro_torch.dsm.costmodel import ChaosNet

_HEAVY_TIMEOUT_S = 120.0      # init/restore/snapshot/gather (bulk pickles,
#   the shard's first CUDA context and kernel load); a failure still
#   fast-paths via EOF


class ReplicaDivergence(RuntimeError):
    """Shard replicas disagreed on a state digest: a protocol bug, not
    a fault to recover from."""


@dataclasses.dataclass
class ClusterReport:
    """What a cluster run went through.  The ``rec_*`` counters are
    deterministic functions of (program, injection schedule, recovery
    mode), gated exactly like traffic; the wall/retry numbers
    (``rpc_retries``, ``rpc_retry_model_s``, ``bar_wall_s``,
    ``round_wall_s``) are real-time measurements and stay ungated."""

    n_events: int = 0
    detections: int = 0
    kills: int = 0
    partitions: int = 0
    respawns: int = 0
    rebinds: int = 0
    replayed_events: int = 0
    checkpoints: int = 0
    digest_rounds: int = 0
    rpc_retries: int = 0
    rpc_retry_model_s: float = 0.0
    bar_wall_s: List[float] = dataclasses.field(default_factory=list)
    # (event index, wall) of every fully-acked round, any event kind
    round_wall_s: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)

    def counters(self) -> Dict[str, int]:
        return {"rec_detections": self.detections,
                "rec_kills": self.kills,
                "rec_partitions": self.partitions,
                "rec_respawns": self.respawns,
                "rec_rebinds": self.rebinds,
                "rec_replayed_events": self.replayed_events,
                "rec_checkpoints": self.checkpoints,
                "rec_digest_rounds": self.digest_rounds}


@dataclasses.dataclass
class ClusterResult:
    """Gathered end state, shaped like a runtime for the exactness
    checks (``ft.coherence.assert_bit_equal(result, baseline_rt)``).
    ``devices`` maps each gathered rank to its runtime's device, and
    ``launches`` sums those ranks' kernel launch counters (each shard
    process's, since it started: a fenced process's are lost)."""

    traffic: Traffic
    clock: np.ndarray
    stats: Dict[str, int]
    report: ClusterReport
    devices: Dict[int, str] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def time(self) -> float:
        return float(self.clock.max())


class ClusterRuntime:
    """N shard processes + membership + recovery behind one driver."""

    def __init__(self, cfg: Dict[str, Any], gas_words: Sequence[int],
                 *, n_shards: int, driver: str,
                 apply_ref: Tuple[str, str], root,
                 recovery: str = "respawn", injector=None,
                 rpc_timeout_s: float = 0.25, rpc_attempts: int = 4,
                 rpc_backoff: float = 2.0):
        if recovery not in ("respawn", "rebind"):
            raise ValueError(f"recovery={recovery!r}; allowed: 'respawn', "
                             "'rebind'")
        W = int(cfg["n_workers"])
        if not 1 <= n_shards <= W:
            raise ValueError(f"n_shards={n_shards} outside [1, {W}]")
        self.cfg = dict(cfg)
        self.gas_words = [int(n) for n in gas_words]
        self.W = W
        self.n_shards = int(n_shards)
        self.driver = driver
        self.apply_ref = tuple(apply_ref)
        self.root = root
        self.recovery = recovery
        self.injector = injector
        self.rpc_attempts = int(rpc_attempts)
        self.rpc_backoff = float(rpc_backoff)
        self.detector = HeartbeatDetector(floor_s=float(rpc_timeout_s))
        self.report = ClusterReport()
        self.membership = MembershipTable()
        self.digests: Dict[int, str] = {}   # event idx -> agreed digest
        self.devices: Dict[int, str] = {}   # rank -> its runtime's device
        self._ctx = mp.get_context("spawn")
        self._chans: Dict[int, ShardChannel] = {}
        self._procs: Dict[int, mp.Process] = {}
        bounds = np.linspace(0, W, self.n_shards + 1).astype(int)
        self._slices = [(int(bounds[r]), int(bounds[r + 1]))
                        for r in range(self.n_shards)]
        try:
            for rank in range(self.n_shards):
                self._spawn(rank, new_member=True)
            toks = {rank: self._chans[rank].start("init",
                                                  self._init_payload(rank))
                    for rank in range(self.n_shards)}
            for rank in range(self.n_shards):
                data, _r = self._chans[rank].finish(
                    toks[rank], timeout_s=_HEAVY_TIMEOUT_S, attempts=1,
                    backoff=self.rpc_backoff)
                self._joined(rank, data)
        except BaseException:
            self.close()
            raise

    # -- process lifecycle ----------------------------------------------
    def _spawn(self, rank: int, *, new_member: bool):
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=shard_main,
                                 args=(child_conn, list(sys.path)),
                                 daemon=True)
        proc.start()
        child_conn.close()     # keep only the shard's copy open there,
        #   so a dead shard turns into EOF on our end instead of a hang
        self._chans[rank] = ShardChannel(parent_conn, rank)
        self._procs[rank] = proc
        if new_member:
            lo, hi = self._slices[rank]
            self.membership.add(rank, proc.pid, lo, hi)
        else:
            self.membership.reincarnate(rank, proc.pid)

    def _init_payload(self, rank: int) -> dict:
        return {"rank": rank, "cfg": self.cfg, "gas_words": self.gas_words,
                "driver": self.driver, "apply_ref": list(self.apply_ref)}

    def _joined(self, rank: int, data: dict):
        self.devices[rank] = data["device"]
        self.membership.mark(rank, ShardState.ALIVE)

    def _init_shard(self, rank: int):
        data, _r = self._chans[rank].request(
            "init", self._init_payload(rank), timeout_s=_HEAVY_TIMEOUT_S)
        self._joined(rank, data)

    def _fence(self, rank: int):
        """Make DEAD mean dead: SIGKILL the process (it may be healthy
        but partitioned: it must not outlive its membership record),
        reap it, drop the channel."""
        proc = self._procs.get(rank)
        if proc is not None:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        ch = self._chans.pop(rank, None)
        if ch is not None:
            ch.close()

    def close(self):
        # tell every shard to stop before reaping any, so that their
        # exits (CUDA context teardown on the card) overlap
        toks = {}
        for rank, ch in list(self._chans.items()):
            try:
                toks[rank] = ch.start("stop", {})
            except ShardDown:
                pass
        for rank in list(self._chans):
            if rank in toks:
                try:
                    self._chans[rank].finish(toks[rank], timeout_s=5.0,
                                             attempts=1, backoff=1.0)
                except (ShardDown, OSError):
                    pass
            self._fence(rank)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- RPC accounting --------------------------------------------------
    def _account_retries(self, levels: int, timeout_s: float):
        if levels <= 0:
            return
        self.report.rpc_retries += levels
        self.report.rpc_retry_model_s += ChaosNet.backoff_seconds(
            timeout_s, self.rpc_backoff, levels)

    # -- rounds ----------------------------------------------------------
    def _apply_round(self, i: int, ev) -> Dict[int, ShardDown]:
        alive = self.membership.alive_ranks()
        assert alive, "no shards left"
        t0 = time.monotonic()
        timeout = self.detector.timeout_s()
        toks: Dict[int, tuple] = {}
        failed: Dict[int, ShardDown] = {}
        for rank in alive:                       # broadcast first ...
            try:
                toks[rank] = self._chans[rank].start(
                    "apply", {"idx": i, "ev": ev})
            except ShardDown as e:
                failed[rank] = e
        digests: Dict[int, str] = {}
        for rank, tok in toks.items():           # ... then collect
            def _suspect(_k, rank=rank):
                self.membership.mark(rank, ShardState.SUSPECT)
            try:
                data, retries = self._chans[rank].finish(
                    tok, timeout_s=timeout, attempts=self.rpc_attempts,
                    backoff=self.rpc_backoff, on_retry=_suspect)
            except ShardDown as e:
                self._account_retries(self.rpc_attempts - 1, timeout)
                failed[rank] = e
                continue
            self._account_retries(retries, timeout)
            self.detector.observe(time.monotonic() - t0)
            self.membership.mark(rank, ShardState.ALIVE)
            digests[rank] = data["digest"]
        if failed:
            return failed
        uniq = set(digests.values())
        if len(uniq) != 1:
            raise ReplicaDivergence(
                f"event {i}: shard digests diverged: {digests}")
        self.report.digest_rounds += 1
        self.digests[i] = uniq.pop()
        wall = time.monotonic() - t0
        self.report.round_wall_s.append((i, wall))
        if ev[0] == "barrier":
            self.report.bar_wall_s.append(wall)
        return {}

    def _checkpoint(self, cursor: int) -> Dict[int, ShardDown]:
        parts = []
        for w_lo, w_hi, rank in self.membership.owners():
            try:
                data, _r = self._chans[rank].request(
                    "snapshot", {"w_lo": w_lo, "w_hi": w_hi},
                    timeout_s=_HEAVY_TIMEOUT_S)
            except ShardDown as e:
                return {rank: e}
            parts.append((data["arrays"], data["meta"]))
        arrays, meta = RegCScaleRuntime.compose_snapshots(parts)
        save_arrays(self.root, cursor, arrays, extra=meta)
        self.report.checkpoints += 1
        return {}

    # -- failure handling -------------------------------------------------
    def _inject(self, kind: str, rank: int):
        rec = self.membership.records.get(rank)
        if rec is None or rec.state not in (ShardState.ALIVE,
                                            ShardState.SUSPECT):
            return
        if kind == "kill":
            self._procs[rank].kill()
            self.report.kills += 1
        elif kind == "partition_c2s":
            self._chans[rank].drop_c2s = True
            self.report.partitions += 1
        elif kind == "partition_s2c":
            self._chans[rank].drop_s2c = True
            self.report.partitions += 1
        else:
            raise ValueError(kind)

    def _recover(self, failed: Dict[int, ShardDown], last_ckpt: int,
                 i: int, prog):
        """Quarantine the dead, then rebind or respawn-replay so the
        retry of round ``i`` finds a full ownership map again."""
        self.report.detections += len(failed)
        for rank in sorted(failed):
            self.membership.mark(rank, ShardState.DEAD)
            self._fence(rank)
            self.membership.mark(rank, ShardState.QUARANTINED)
        survivors = self.membership.alive_ranks()
        if self.recovery == "rebind" and survivors:
            for j, rank in enumerate(sorted(failed)):
                self.membership.rebind(rank,
                                       survivors[j % len(survivors)])
                self.report.rebinds += 1
            return
        arrays, meta = load_arrays(self.root, last_ckpt)
        suffix = list(prog[last_ckpt:i])
        for rank in sorted(failed):
            self._spawn(rank, new_member=False)
            self._init_shard(rank)
            self._chans[rank].request(
                "restore", {"arrays": arrays, "meta": meta,
                            "gas_words": self.gas_words,
                            "cursor": last_ckpt, "suffix": suffix},
                timeout_s=_HEAVY_TIMEOUT_S)
            self.report.respawns += 1
            self.report.replayed_events += len(suffix)

    # -- driver -----------------------------------------------------------
    def run(self, prog) -> ClusterResult:
        inj = self.injector
        self.report.n_events += len(prog)
        failed = self._checkpoint(0)
        assert not failed, "shard died before the t=0 checkpoint"
        last_ckpt = 0
        i = 0
        while i < len(prog):
            if inj is not None:
                for kind, rank in inj.cluster_actions(i + 1):
                    self._inject(kind, rank)
            failed = self._apply_round(i, prog[i])
            if not failed and prog[i][0] == "barrier":
                failed = self._checkpoint(i + 1)
            if failed:
                self._recover(failed, last_ckpt, i, prog)
                continue          # retry round i (dedup-idempotent)
            if prog[i][0] == "barrier":
                last_ckpt = i + 1
            i += 1
        return self._gather()

    def _gather(self) -> ClusterResult:
        clock = np.zeros(self.W, np.float64)
        traffic: Optional[dict] = None
        stats: Optional[dict] = None
        launches: Dict[int, Dict[str, int]] = {}
        for w_lo, w_hi, rank in self.membership.owners():
            data, _r = self._chans[rank].request(
                "gather", {"w_lo": w_lo, "w_hi": w_hi},
                timeout_s=_HEAVY_TIMEOUT_S)
            clock[w_lo:w_hi] = data["clock"]
            launches[rank] = data["launches"]
            if traffic is None:
                traffic, stats = data["traffic"], data["stats"]
            elif data["traffic"] != traffic or data["stats"] != stats:
                raise ReplicaDivergence(
                    f"shard {rank}: replica traffic or stats diverged at "
                    "gather")
        total: Dict[str, int] = {}
        for counts in launches.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        return ClusterResult(traffic=Traffic(**traffic), clock=clock,
                             stats=stats, report=self.report,
                             devices={r: self.devices[r] for r in launches},
                             launches=total)
