"""Dry run of a production cell: one rank's step counted on ``meta``
tensors, and its roofline on an H100 (the port of the reference's
``launch/dryrun.py``).

The reference lowers and compiles its GSPMD program for every device of
a TPU mesh that does not exist and reads XLA's analyses.  The port runs
the real code path of one rank of that mesh: ``launch.specs.dry_target``
builds the rank's step and its blocks as ``meta`` tensors on a
``launch.mesh.AbstractMesh`` (no process group; the collectives count
their messages and send nothing), and ``launch.op_analysis.analyze``
counts what the step does, op by op.  ``meta`` is the default device
for the reason the reference's dry run needs no TPU: nothing is
allocated and nothing computed, so a 256-device cell counts in seconds
on any host.  Another device (``--device cpu`` or ``cuda``) runs the
same step on zero-filled tensors there, and says so.

What a count on ``meta`` holds: every op of the rank's step, with its
operands' shapes, the attention and SSD kernels as their plain
versions' full products (``kernels._build.on_card``), the collectives'
messages and bytes.  What it cannot hold: a time (nothing runs), the
card's kernels' own work (the causal flash_attention skips about half of
the plain products), the caching allocator's rounding and
fragmentation, and the CUDA context (``total_live`` sums tensor bytes).

A cell's record keeps the reference's keys: ``arch``, ``shape``,
``mesh``, ``devices``, ``variant``, ``ok``, ``memory_per_device``,
``per_device``, ``model_flops_global``, ``roofline``; ``count_s`` (the
counting's wall) takes the place of ``lower_s`` and ``compile_s``.
``memory_per_device``:

* ``arguments``: the bytes of the rank's parameter, optimiser-state and
  batch blocks (decode: and its cache blocks), split out as ``params``,
  ``opt_state``, ``batch`` and ``caches``;
* ``outputs``: the bytes of what the step returns;
* ``peak_created``: the most that the storages the step creates held
  at once, tracked from the op that made each until it was freed;
* ``total_live``: ``arguments + peak_created``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \
        --shape train_4k [--mesh single|multi|both] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import all_cells, get_config, get_shape
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import (
    HBM_BW, NET_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32, make_production_mesh,
)
from repro_torch.launch.specs import dry_target, model_flops
from repro_torch.models.sharding import NAMED_RULES
from repro_torch.train.train_step import TrainHParams

OUT_DIR = Path("build/dryrun")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def peak_flops(dtype) -> float:
    """The card's peak for a cell's dtype: bf16 on the tensor cores,
    float32 on the CUDA cores."""
    return PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS_BF16


def _on(tree, device):
    """``tree``'s meta tensors as zero-filled tensors on ``device``."""
    if torch.is_tensor(tree):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_on(v, device) for v in tree]
        if hasattr(tree, "max_len"):
            return type(tree)(out, tree.max_len)
        return type(tree)(out)
    return tree


def count_step(cfg, shape, mesh, *, hp=None, param_dtype=torch.bfloat16,
               rules_override=None, device="meta", **ctx_opts):
    """(memory_per_device, ``OpStats``, count_s) of rank ``mesh.rank``'s
    step of ``cfg`` at ``shape`` on ``mesh`` (an ``AbstractMesh``),
    counted on ``device``."""
    t0 = time.perf_counter()
    target = dry_target(cfg, shape, mesh, hp=hp, param_dtype=param_dtype,
                        rules_override=rules_override, **ctx_opts)
    args = target.args
    if torch.device(device).type != "meta":
        args = _on(args, device)
    out, st = op_analysis.analyze(target.fn, *args, mesh=mesh)
    outputs = sum(t.numel() * t.element_size()
                  for t in op_analysis.tensors(out))
    del out, args
    mem = dict(target.resident)
    mem["arguments"] = sum(target.resident.values())
    mem["outputs"] = outputs
    mem["peak_created"] = st.peak_bytes
    mem["total_live"] = mem["arguments"] + st.peak_bytes
    return mem, st, time.perf_counter() - t0


def per_device(st: op_analysis.OpStats) -> dict:
    return {
        "flops": st.flops,
        "bytes_accessed": st.bytes_accessed,
        "bytes_hbm_est": st.bytes_hbm_est,
        "bytes_dot": st.bytes_dot,
        "bytes_entry": st.bytes_entry,
        "collective_bytes": dict(st.collective_bytes),
        "collective_count": dict(st.collective_count),
        "collective_bytes_total": st.total_collective_bytes,
        "dot_count": st.dot_count,
        "ops": st.ops,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             hp: TrainHParams = None, variant: str = "baseline",
             rules_override=None, param_dtype=torch.bfloat16,
             device="meta", **ctx_opts) -> dict:
    """The record of rank 0's step of one production cell (see the
    module's note); a failure is recorded (``ok`` False, ``error``,
    ``traceback``), not raised.  ``main`` writes it."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size(mesh.axes)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev, "variant": variant, "ok": False,
        "device": str(device),
        "dtype": str(param_dtype).replace("torch.", ""),
    }
    try:
        mem, st, count_s = count_step(
            cfg, shape, mesh, hp=hp, param_dtype=param_dtype,
            rules_override=rules_override, device=device, **ctx_opts)
        rec["count_s"] = round(count_s, 2)
        rec["memory_per_device"] = mem
        rec["per_device"] = per_device(st)
        mf = model_flops(cfg, shape)
        rec["model_flops_global"] = mf
        rec["roofline"] = roofline_terms(st, n_dev, mf,
                                         peak_flops(param_dtype))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def roofline_terms(st: op_analysis.OpStats, n_dev: int,
                   model_flops_global: float, peak: float = PEAK_FLOPS_BF16):
    """Three-term roofline (seconds) from a rank's counts, on the H100
    constants of ``launch.mesh`` (``peak``: the cell's dtype's)."""
    t_compute = st.flops / peak
    t_memory = st.bytes_hbm_est / HBM_BW
    t_coll = st.total_collective_bytes / NET_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1])[0]
    op_flops_global = st.flops * n_dev
    bound = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "peak_flops": peak,
        "model_flops/hlo_flops": (
            model_flops_global / op_flops_global if op_flops_global else 0.0),
        "mfu_upper_bound": (
            model_flops_global / (bound * n_dev * peak) if bound > 0
            else 0.0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="dry run of production cells: one rank's step counted "
                    "on meta tensors, roofline on H100 constants")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--remat-segment", type=int, default=0)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ce-chunk", type=int, default=1024)
    ap.add_argument("--moe-impl", choices=["dense", "ep"], default="dense")
    ap.add_argument("--no-gather-fsdp", action="store_true",
                    help="keep FSDP shard on weights (decode variant)")
    ap.add_argument("--opt-impl", choices=["adamw", "adamw8bit"],
                    default="adamw")
    ap.add_argument("--rules", default="default",
                    help="named sharding rules override (see NAMED_RULES)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="parameter dtype; the roofline's peak follows it")
    ap.add_argument("--device", default="meta",
                    help="where the step runs (meta: shapes only)")
    args = ap.parse_args(argv)
    if (args.arch is None or args.shape is None) and not args.all:
        ap.error("give --arch and --shape, or --all")

    device = torch.device(args.device)
    if device.type != "meta":
        print(f"counting on {device}: the step runs there on zero-filled "
              "tensors at the rank's full block shapes", flush=True)
    rules_override = NAMED_RULES[args.rules]
    out_dir = Path(args.out)
    if "artifacts" in out_dir.resolve().parts:
        raise SystemExit(f"--out {out_dir}: the port writes nothing under "
                         "artifacts/ (the reference's records)")
    out_dir.mkdir(parents=True, exist_ok=True)
    hp = TrainHParams(remat=args.remat or None, n_micro=args.n_micro,
                      ce_chunk=args.ce_chunk,
                      remat_segment=args.remat_segment,
                      opt_impl=args.opt_impl)

    cells = []
    if args.all:
        for arch, shapes in all_cells().items():
            cells += [(arch, s) for s in shapes]
    else:
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            mesh_tag = "2x16x16" if mp else "16x16"
            key = f"{arch}__{shape_name}__{mesh_tag}__{args.variant}"
            path = out_dir / (key + ".json")
            rec = run_cell(arch, shape_name, mp, hp=hp, variant=args.variant,
                           rules_override=rules_override,
                           param_dtype=DTYPES[args.dtype],
                           device=device, moe_impl=args.moe_impl,
                           gather_fsdp=not args.no_gather_fsdp)
            path.write_text(json.dumps(rec, indent=1, default=float))
            if rec["ok"]:
                r = rec["roofline"]
                print(f"OK   {key}  count={rec['count_s']}s "
                      f"dom={r['dominant']} bound={r['bound_s']*1e3:.2f}ms "
                      f"mfu_ub={r['mfu_upper_bound']:.3f} "
                      f"mem={rec['memory_per_device']['total_live']/2**30:.2f}"
                      f"GiB -> {path}", flush=True)
            else:
                n_fail += 1
                print(f"FAIL {key}: {rec['error']}", flush=True)
            gc.collect()
    if n_fail:
        raise SystemExit(f"{n_fail} cell(s) failed")


if __name__ == "__main__":
    main()
