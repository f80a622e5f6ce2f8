"""Starting the ranks of a data-parallel run under ``torch.distributed``.

The backend is always the caller's explicit choice; nothing here picks
or switches one.  The one backend is gloo, on the CPU and, for ranks
that share one card, on the card too (NCCL refuses two ranks on one
device).

* ``init_world(backend)``: the default process group of this process.
  Under ``python -m torch.distributed.run`` (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT`` set) it joins that world; with none of
  them set the world is this one process (an in-memory store).  An
  already initialised group is used as it is.
* ``rank_device(device)``: the device of this rank: ``"cuda"`` names
  card ``LOCAL_RANK`` modulo the cards there are (so ranks share a card
  when there are more ranks than cards).
* ``spawn_ranks(world, target, args, backend=, init_method=)``: starts
  ``world`` processes with the ``spawn`` method (a card's context cannot
  cross a fork), each on one intra-op thread, runs
  ``target`` ("module:function") in each with the world initialised and
  returns their results in rank order.  A rank that raises or dies fails
  the call, naming the rank, and the others are stopped.
"""
from __future__ import annotations

import importlib
import os
import queue as queue_mod
import sys
import time
import traceback
from datetime import timedelta
from typing import Any, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.config import resolve_device

BACKENDS = ("gloo",)


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; allowed: {BACKENDS}")


TIMEOUT = timedelta(seconds=600)


def init_world(backend: str = "gloo") -> bool:
    """Initialise the default process group (see the module's note).
    Returns True when this call made it (the caller then destroys it)."""
    _check_backend(backend)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}, not {backend}")
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    return True


def rank_device(device="cuda") -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               target: str, args: tuple, sys_path: List[str], out):
    for p in sys_path:
        if p not in sys.path:
            sys.path.append(p)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=TIMEOUT)
        module, fn = target.split(":")
        result = getattr(importlib.import_module(module), fn)(*args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world: int, target: str, args: Sequence = (), *,
                backend: str, init_method: str,
                timeout_s: float = 900.0) -> List[Any]:
    """Run ``target(*args)`` on ``world`` spawned ranks (see the module's
    note); ``init_method`` is where they meet (``file://`` of a path
    that does not exist yet, or ``tcp://host:port``)."""
    _check_backend(backend)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, init_method, target,
                               tuple(args), list(sys.path), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} died (exit code "
                        f"{procs[dead[0]].exitcode}) running {target}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target} on {world} ranks took "
                                       f"over {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed in "
                                   f"{target}:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
    return [results[r] for r in range(world)]
