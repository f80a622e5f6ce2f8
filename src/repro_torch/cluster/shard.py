"""Shard process: a deterministic RegC replica behind an RPC loop.

Each shard process runs the full-width ``RegCScaleRuntime`` as a
deterministic replicated state machine: every shard applies the same
event stream in the same order, so all replicas hold bit-identical
protocol state at every round.  What makes a shard a *shard* is slice
ownership, not slice computation: the control plane asks each rank for
``snapshot(rows=its slice)`` at checkpoints and for its slice of the
clocks at gather, and the cross-shard agreement checks (per-round state
digests here, replicated-global equality in ``compose_snapshots``) turn
the redundancy into a divergence detector.

On the card every shard holds its replica's directory planes as CUDA
tensors on the one device and launches the flush kernels itself; the
shards of one card share it.  The kernel libraries are loaded, and the
runtime placed on its device, inside ``init``, under the control
plane's heavy timeout, so no ``apply`` round pays for a build or a first
load.  Nothing sent over the pipe is a torch tensor: snapshots, events,
clocks and stats are numpy arrays and Python values.

The RPC loop is crash-ready by construction: all state is process-local,
requests are deduplicated by event index (a re-send after a lost ack
re-acks without re-applying), and the process can be SIGKILL'd at any
instant; recovery is always restore-from-checkpoint + replay in a fresh
process, never in-place repair.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import sys
import traceback
from typing import Any, Dict, List, Tuple

import numpy as np


def state_digest(rt) -> str:
    """Order-stable fingerprint of the replica-visible runtime state:
    clocks bit for bit, traffic field for field, stats counters.  Equal
    digests across shards == the replicas took identical engine paths."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(rt.clock).tobytes())
    h.update(repr(sorted(dataclasses.asdict(rt.traffic).items())).encode())
    h.update(repr(sorted(rt.stats.items())).encode())
    return h.hexdigest()


def make_runtime(cfg: Dict[str, Any]):
    """Build a runtime from the JSON-ish config the control plane ships
    (the same shape ``snapshot()`` meta uses for chaos/straggler).

    ``backend`` is read in either vocabulary.  A config without one gets
    'fused', the tier of the card paths (the reference's default there,
    'numpy', has the CPU-only 'plain' as its counterpart).  ``device``
    absent means the card, which raises where there is none; the CPU is
    used only when the config names it."""
    from repro_torch.core.regc_scale import _OUR_BACKEND, RegCScaleRuntime
    from repro_torch.dsm.costmodel import ChaosNet, CostModel
    from repro_torch.ft.runtime import StragglerMonitor

    chaos = None
    if cfg.get("chaos") is not None:
        chaos = ChaosNet(**cfg["chaos"])
    straggler = None
    if cfg.get("straggler") is not None:
        straggler = StragglerMonitor(
            int(cfg["straggler"]["n_workers"]),
            window=int(cfg["straggler"]["window"]),
            k=float(cfg["straggler"]["k"]),
            abs_floor_s=float(cfg["straggler"]["abs_floor_s"]),
            patience=int(cfg["straggler"]["patience"]))
    backend = cfg.get("backend", "fused")
    kw = dict(page_words=int(cfg.get("page_words", 1024)),
              protocol=cfg["protocol"],
              cache_pages=cfg.get("cache_pages"),
              fetch_batch=int(cfg.get("fetch_batch", 1)),
              backend=_OUR_BACKEND.get(backend, backend),
              danger_mode=cfg.get("danger_mode", "vec"),
              detect_races=bool(cfg.get("detect_races", False)),
              chaos=chaos, straggler=straggler, device=cfg.get("device"))
    if cfg.get("cost") is not None:
        kw["cost"] = CostModel(**cfg["cost"])
    return RegCScaleRuntime(int(cfg["n_workers"]), **kw)


def _resolve_apply(apply_ref: Tuple[str, str]):
    mod, attr = apply_ref
    return getattr(importlib.import_module(mod), attr)


class _ShardServer:
    """Request dispatcher: one instance per shard process lifetime."""

    def __init__(self):
        self.rt = None
        self.gas: List = []
        self.driver = "batched"
        self.apply_event = None
        self.rank = -1
        self.backend = "fused"
        self.device = None
        # index of the NEXT event to apply; requests for idx below this
        # are duplicates and re-ack with the cached digest
        self.applied_upto = 0
        self.last_digest = ""

    # -- ops ------------------------------------------------------------
    def op_init(self, p):
        from repro_torch.kernels import protocol_sweep
        self.rank = int(p["rank"])
        self.driver = p["driver"]
        self.apply_event = _resolve_apply(p["apply_ref"])
        self.rt = make_runtime(p["cfg"])
        self.backend, self.device = self.rt.backend, self.rt.device
        if self.device.type == "cuda":
            # build (if need be) and load the flush kernels now, so that
            # no apply round waits on nvcc or a first load
            protocol_sweep.load()
        self.gas = [self.rt.alloc(int(n)) for n in p["gas_words"]]
        self.applied_upto = 0
        self.last_digest = state_digest(self.rt)
        return {"digest": self.last_digest, "device": str(self.device)}

    def _apply_one(self, ev):
        from repro_torch.ft.coherence import harness_ticks
        if harness_ticks(ev, self.driver):
            self.rt.chaos_tick()
        self.apply_event(self.rt, ev, self.gas, self.driver)

    def op_apply(self, p):
        idx = int(p["idx"])
        if idx == self.applied_upto:
            self._apply_one(p["ev"])
            self.applied_upto = idx + 1
            self.last_digest = state_digest(self.rt)
        elif idx != self.applied_upto - 1:
            raise AssertionError(
                f"shard {self.rank}: apply idx {idx} vs "
                f"applied_upto {self.applied_upto}")
        # idx == applied_upto - 1 is a duplicate re-send: re-ack only
        return {"idx": idx, "digest": self.last_digest}

    def op_snapshot(self, p):
        arrays, meta = self.rt.snapshot(
            rows=(int(p["w_lo"]), int(p["w_hi"])))
        return {"arrays": arrays, "meta": meta}

    def op_restore(self, p):
        from repro_torch.core.regc_scale import RegCScaleRuntime
        # the meta names the reference's tier and no device: restore on
        # this shard's own
        self.rt = RegCScaleRuntime.from_snapshot(
            p["arrays"], p["meta"], backend=self.backend, device=self.device)
        self.gas = [self.rt.gas_for_region(r, int(n))
                    for r, n in enumerate(p["gas_words"])]
        self.applied_upto = int(p["cursor"])
        for ev in p["suffix"]:
            self._apply_one(ev)
            self.applied_upto += 1
        self.last_digest = state_digest(self.rt)
        return {"digest": self.last_digest,
                "applied_upto": self.applied_upto}

    def op_gather(self, p):
        from repro_torch.kernels import protocol_sweep
        w_lo, w_hi = int(p["w_lo"]), int(p["w_hi"])
        return {"clock": self.rt.clock[w_lo:w_hi].copy(),
                "traffic": dataclasses.asdict(self.rt.traffic),
                "stats": dict(self.rt.stats),
                "digest": state_digest(self.rt),
                # this process's kernel launches since it started
                "launches": dict(protocol_sweep.LAUNCHES)}

    def op_ping(self, p):
        return {"applied_upto": self.applied_upto}

    def serve(self, conn):
        while True:
            try:
                seq, op, payload = conn.recv()
            except (EOFError, OSError):
                return                      # control plane went away
            if op == "stop":
                conn.send((seq, "ok", {}))
                return
            try:
                data = getattr(self, f"op_{op}")(payload)
                conn.send((seq, "ok", data))
            except Exception:
                # a boundary that must keep serving: the traceback goes
                # back to the control plane as a ShardError
                try:
                    conn.send((seq, "err", traceback.format_exc()))
                except (BrokenPipeError, OSError):
                    return


def shard_main(conn, sys_path: List[str]):
    """Spawn-context entry point.  ``sys_path`` is the parent's import
    path: the spawned interpreter starts from the bare environment and
    must be able to import the runtime and the caller's ``apply_event``
    module (e.g. the trace-fuzz executor under ``tests/``)."""
    for p in sys_path:
        if p not in sys.path:
            sys.path.append(p)
    _ShardServer().serve(conn)
    conn.close()
