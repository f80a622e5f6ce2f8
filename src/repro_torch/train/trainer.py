"""Trainer: the fault-tolerant training loop (the port of the reference's
``train/trainer.py``).

It wires the data pipeline (stateless by step, prefetched), the train
step, the checkpoint manager (async, keep-last-k) and the FT runtime
(failure injection -> restore -> resume; straggler monitor).  All mutable
state is (params, opt_state, step); everything else is rebuilt from the
configs, so recovery is a restore and a jump of the pipeline.

``path="gspmd"`` runs ``make_train_step`` in one process, or with a
sharding context ``ctx`` (over ``mesh``, a ``launch.mesh.Mesh``) on
every rank of the mesh, each holding its blocks of the state.
``path="regc"`` runs ``make_train_step_regc`` on every rank of ``mesh``
over ``tc.dp_axes`` (with ``ctx`` as its ``inner_ctx``).  On several
ranks every rank runs the same global pipeline and keeps its rows; the
state starts as the full seeded tree, cut into each rank's blocks;
rank 0 writes the checkpoints, of the gathered tree in the reference's
layout, and a barrier follows each save; before a restore rank 0's
writes end and a barrier lets every rank read the same latest step (and
cut its blocks from it), so an injected ``WorkerFailure`` (raised on
every rank at the same step) restarts every rank there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.ft import FailureInjector, StragglerMonitor, WorkerFailure
from repro_torch.train.train_step import (
    TrainHParams, gather_state, init_train_state, make_train_step,
    make_train_step_regc, shard_state,
)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "ckpts"
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10
    path: str = "gspmd"               # 'gspmd' | 'regc'
    dp_axes: tuple = ("data",)
    max_restarts: int = 3
    seed: int = 0


class Trainer:
    """``run()`` trains from the latest checkpoint in ``tc.ckpt_dir`` (or
    from parameters seeded with ``tc.seed``) to ``tc.total_steps`` on
    ``device`` (the card unless the CPU is asked for; raises without a
    card), restarting after a ``WorkerFailure`` up to ``tc.max_restarts``
    times.  On ``path="regc"``, or with a ``ctx``, every rank of
    ``mesh`` makes its own Trainer, on its own ``device``."""

    def __init__(self, cfg: ModelConfig, hp: TrainHParams, tc: TrainerConfig,
                 data: DataConfig, *, mesh=None, ctx=None,
                 injector: Optional[FailureInjector] = None,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        if tc.path not in ("gspmd", "regc"):
            raise ValueError(f"path={tc.path!r}; allowed: 'gspmd', 'regc'")
        if ctx is not None and mesh is not None and ctx.mesh is not mesh:
            raise ValueError("ctx lies on another mesh than mesh=")
        self.device = resolve_device(device)
        self.cfg, self.hp, self.tc, self.data = cfg, hp, tc, data
        self.ctx = ctx
        self.injector = injector
        self.log = log_fn
        if tc.path == "regc":
            if mesh is None:
                raise ValueError("the explicit RegC path needs a mesh")
            self.step_fn = make_train_step_regc(cfg, hp, mesh,
                                                dp_axes=tc.dp_axes,
                                                inner_ctx=ctx)
        else:
            self.step_fn = make_train_step(cfg, hp, ctx)
        self.ranks = tc.path == "regc" or ctx is not None
        self.writer = not self.ranks or dist.get_rank() == 0
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep,
                                      async_write=tc.ckpt_async)
        self.straggler = StragglerMonitor(1)
        self.history: List[Dict] = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def _init_state(self):
        """The full seeded tree (every rank draws the same); the
        optimiser state the step updates: AdamW's moments, or with
        ``opt_impl="adamw8bit"`` on the GSPMD path the int8 state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params, opt = init_train_state(self.cfg, gen, device=self.device)
        if self.hp.opt_impl == "adamw8bit" and self.tc.path == "gspmd":
            from repro_torch.optim.quantized import init_opt_state_q8
            opt = init_opt_state_q8(params)
        return params, opt

    def _barrier(self):
        if self.ranks:
            dist.barrier()

    def _local(self, params, opt):
        if self.ctx is None:
            return params, opt
        return shard_state(self.cfg, self.ctx, params, opt)

    def _resume_or_init(self):
        self.ckpt.wait()        # rank 0's writes end before anyone reads
        self._barrier()
        last = self.ckpt.latest()
        if last is None:
            return (*self._local(*self._init_state()), 0)
        params_t, opt_t = self._init_state()
        state = self.ckpt.restore(last, {"params": params_t, "opt": opt_t})
        self.log(f"[trainer] restored checkpoint step={last}")
        return (*self._local(state["params"], state["opt"]), last)

    def _save(self, step, params, opt, loss):
        """Rank 0 writes the full tree (gathered by every rank first)."""
        if self.ctx is not None:
            params, opt = gather_state(self.cfg, self.ctx, params, opt)
        if self.writer:
            self.ckpt.save(step, {"params": params, "opt": opt},
                           extra={"loss": loss})
        self._barrier()

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        while True:
            try:
                return self._run_inner()
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.tc.max_restarts:
                    raise
                self.log(f"[trainer] {e} -> restart "
                         f"{self.restarts}/{self.tc.max_restarts}")

    def _run_inner(self) -> Dict:
        params, opt, start = self._resume_or_init()
        pipe = make_pipeline(self.data, start_step=start, device=self.device)
        t_prev = time.perf_counter()
        try:
            step = start
            while step < self.tc.total_steps:
                step, batch = next(pipe)
                if self.injector is not None:       # simulated failure point
                    self.injector.check(step)
                params, opt, metrics = self.step_fn(params, opt, batch, step)
                loss = float(metrics["loss"])       # blocks; paces the loop
                now = time.perf_counter()
                dur = now - t_prev
                t_prev = now
                slow = self.straggler.observe([dur])
                rec = {"step": step, "loss": loss, "t_s": dur,
                       "straggler": bool(slow)}
                self.history.append(rec)
                if step % self.tc.log_every == 0:
                    self.log(f"[trainer] step={step} loss={loss:.4f} "
                             f"({dur*1e3:.0f} ms)")
                next_step = step + 1
                if next_step % self.tc.ckpt_every == 0 \
                        or next_step == self.tc.total_steps:
                    self._save(next_step, params, opt, loss)
                step = next_step
        finally:
            pipe.close()
        self.ckpt.wait()
        self._barrier()
        return {"params": params, "opt": opt, "step": step,
                "history": self.history, "restarts": self.restarts}
