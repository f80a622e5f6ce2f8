#!/usr/bin/env python3
"""Where a rank's sharded training step under ``TRAIN_SP_RULES`` spends
its time: phase 9d (a) of ``chip_smoke.py`` (mamba2-2.7b at full width, 2
layers, mesh (2, 2) ("data", "model"), 4 x 1024 tokens, ``adamw8bit``,
remat "full") on four ranks sharing one card over gloo.

Run from the root of a checkout on a machine with one CUDA card:

    python3 sp_probe.py

Each rank takes the step twice from the same state.  For each step it
prints (rank 0's) wall, then the step's three parts taken again one
after another (the loss and its gradients, the gradients' sum over the
batch axes, the optimiser update), and every collective's calls,
seconds (each call between two ``torch.cuda.synchronize``) and operand
bytes, for the staging wrappers of ``models.collectives`` and for the
gloo calls inside them.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _timed(torch, dev, name, fn, table):
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        x = args[1] if name in ("dist.all_gather", "dist.reduce_scatter") \
            else args[0]
        xs = [x] if torch.is_tensor(x) else list(x)
        row = table[name]
        row[0] += 1
        row[1] += time.perf_counter() - t0
        row[2] += sum(t.numel() * t.element_size() for t in xs)
        return out
    return wrapped


def rank(batch):
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import collectives as C
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_param
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import tree_unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device("cuda")
    mesh = make_host_mesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2)
    ctx = SH.ShardingCtx(mesh, SH.TRAIN_SP_RULES)
    hp = cs.sp_hp("adamw8bit")
    specs = T.leaf_specs(cfg, ctx)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_unflatten(param_specs(cfg), [
        SH.owned_block(init_param(p, gen, torch.float32), s, mesh)
        for p, s in zip(SH.spec_leaves(param_specs(cfg)), specs)])
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    wrapped = [(C, n) for n in ("reduce", "gather", "reduce_scatter")] + [
        (dist, n) for n in ("all_reduce", "all_gather", "reduce_scatter")]
    out = []
    for _ in range(2):
        opt = cs.sp_zero_state(torch, cfg, ctx, params, "adamw8bit")
        calls = collections.defaultdict(lambda: [0, 0.0, 0])
        saved = {(m, n): getattr(m, n) for m, n in wrapped}
        for (m, n), fn in saved.items():
            label = ("C." if m is C else "dist.") + n
            setattr(m, n, _timed(torch, dev, label, fn, calls))
        try:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, _, m = T.make_train_step(cfg, hp, ctx)(params, opt, tb, 0)
            float(m["loss"])
            wall = time.perf_counter() - t0
        finally:
            for (mod, n), fn in saved.items():
                setattr(mod, n, fn)
        parts = {}
        t0 = time.perf_counter()
        layout = T.batch_layout(cfg, ctx, tb)
        (_, _), g = T.value_and_grad(T._loss_f(cfg, hp, layout), params,
                                     T.local_rows(cfg, tb, layout))
        torch.cuda.synchronize(dev)
        parts["value_and_grad"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        g = T.sync_sharded_grads(g, specs, layout)
        torch.cuda.synchronize(dev)
        parts["sync"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            T.apply_sharded_update(params, g, opt, 0, m["lr"], hp, specs,
                                   mesh, T.q8_shards(cfg, ctx))
        torch.cuda.synchronize(dev)
        parts["update"] = time.perf_counter() - t0
        out.append({"wall": wall, **parts, "calls": dict(calls)})
    return out if dist.get_rank() == 0 else None


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sp_probe.py: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.ranks import spawn_ranks
    print(cs.card_line(), flush=True)
    _build.build(*(Path(p).name for p in cs.SOURCES.values()))
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2)
    batch = cs.train_batch(np, cfg, 4, 1024)
    work = ROOT / "build" / "sp_probe"
    work.mkdir(parents=True, exist_ok=True)
    store = work / f"store_{time.time_ns()}"
    steps = spawn_ranks(4, "sp_probe:rank", (batch,), backend="gloo",
                        init_method=f"file://{store}", timeout_s=600)[0]
    for i, row in enumerate(steps):
        print(f"step {i}: wall {row['wall']:.3f} s; again in parts: loss "
              f"and gradients {row['value_and_grad']:.3f} s, sum over the "
              f"batch axes {row['sync']:.3f} s, update {row['update']:.3f} s",
              flush=True)
        for name, (n, secs, nbytes) in sorted(row["calls"].items()):
            print(f"    {name}: {n} calls, {secs:.3f} s, {nbytes} B",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
