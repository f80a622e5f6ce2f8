"""Roofline report: the dry run's records (``build/dryrun/*.json``) as a
markdown table of the three terms, the dominant one, the useful-flops
ratio, the memory a card and a what-would-move-it note per cell (the
port of the reference's ``launch/roofline.py``, on the H100 constants of
``launch.mesh``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--variant baseline]
        [--mesh 16x16] [--art build/dryrun] [--md-out build/roofline.md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.mesh import HBM_PER_CHIP

NOTE_RULES = [
    # (predicate, note) — first match wins
    (lambda r: r["dominant"] == "collective" and r["shape"].startswith("decode")
     and r["fsdp_like"],
     "per-token FSDP weight all-gather dominates; switch decode to 2-D TP "
     "(weights sharded over both axes, no regather)"),
    (lambda r: r["dominant"] == "collective" and r["moe"],
     "MoE dispatch/combine all-reduces dominate; shard experts (EP) with "
     "all-to-all and cap capacity factor"),
    (lambda r: r["dominant"] == "collective" and r["shape"] == "train_4k",
     "gradient/activation all-reduces dominate; reduce-scatter + overlap "
     "with backward, or rebalance TP<->DP"),
    (lambda r: r["dominant"] == "collective",
     "context-parallel KV gathers dominate; stage them over the faster "
     "intra-pod axis only"),
    (lambda r: r["dominant"] == "memory" and r["shape"].startswith(("decode",
                                                                    "long")),
     "weight+KV streaming is the floor at batch*1 token; raise arithmetic "
     "intensity via batched decode or quantized KV"),
    (lambda r: r["dominant"] == "memory" and r["useful"] < 0.2,
     "the step moves far more bytes than the model needs — remat recompute "
     "+ O(S^2) attention materialization; use flash-attention kernel"),
    (lambda r: r["dominant"] == "memory",
     "bytes/flop too high: fuse softmax/norms, keep activations bf16, "
     "shard the long axis"),
    (lambda r: r["useful"] < 0.5,
     "compute-bound but <50% useful flops: relax remat (pay memory for "
     "fewer recomputed dots)"),
    (lambda r: True,
     "near compute roofline; remaining waste is remat recompute"),
]


def improvement_note(rec: dict) -> str:
    roof = rec["roofline"]
    ctx = {
        "dominant": roof["dominant"],
        "shape": rec["shape"],
        "useful": roof["model_flops/hlo_flops"],
        "moe": any(a in rec["arch"] for a in
                   ("moonshot", "grok", "jamba")),
        "fsdp_like": rec["arch"] in ("llama3-405b", "qwen2-vl-72b",
                                     "gemma2-27b", "jamba-1.5-large-398b",
                                     "grok-1-314b", "moonshot-v1-16b-a3b"),
    }
    for pred, note in NOTE_RULES:
        if pred(ctx):
            return note
    return ""


def load(variant: str, mesh: str, art: Path):
    rows = []
    for f in sorted(art.glob(f"*__{variant}.json")):
        r = json.loads(f.read_text())
        if r.get("ok") and (mesh is None or r["mesh"] == mesh):
            rows.append(r)
    return rows


def to_markdown(recs, *, title: str) -> str:
    cap = f"{HBM_PER_CHIP / 2**30:.1f}G"
    lines = [
        f"### {title}",
        "",
        "| arch | shape | mesh | t_compute | t_memory | t_collective | "
        "dominant | MODEL/counted flops | MFU bound | mem/card | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        roof = r["roofline"]
        mem = r["memory_per_device"]["total_live"]
        fits = "" if mem <= HBM_PER_CHIP else f" **(>{cap})**"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {roof['t_compute_s']*1e3:,.1f} ms "
            f"| {roof['t_memory_s']*1e3:,.1f} ms "
            f"| {roof['t_collective_s']*1e3:,.1f} ms "
            f"| {roof['dominant']} "
            f"| {roof['model_flops/hlo_flops']:.3f} "
            f"| {roof['mfu_upper_bound']:.4f} "
            f"| {mem/2**30:.1f} GiB{fits} "
            f"| {improvement_note(r)} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--art", default="build/dryrun")
    ap.add_argument("--md-out", default=None)
    args = ap.parse_args(argv)
    recs = load(args.variant, args.mesh, Path(args.art))
    md = to_markdown(recs, title=f"Roofline (H100) — variant={args.variant}, "
                                 f"mesh={args.mesh} ({len(recs)} cells)")
    if args.md_out:
        Path(args.md_out).write_text(md)
        print(f"wrote {args.md_out}")
    else:
        print(md)


if __name__ == "__main__":
    main()
