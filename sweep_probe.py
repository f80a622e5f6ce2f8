#!/usr/bin/env python3
"""Time popcount_rows and coverage_multi, and the directory calls and
points that run them, of one tree's ``repro_torch`` on a CUDA card, so
that two trees can be compared inside one call (run it once per tree,
in turns).

    python3 sweep_probe.py [--src DIR] [--tag NAME]

DIR is the root of a checkout (default: the one holding this script);
its ``src/repro_torch`` is imported and its CUDA sources are built into
DIR/build.  The probe takes either interface of the two kernels: the
packed one (``popcount_rows`` on int32 words that ``pack_rows`` made of
the bool plane; ``coverage_multi`` on the +1/-1 deltas of bounds that
the host sorted) or the bool one (``popcount_rows`` on the bool rows as
they lie; ``coverage_multi`` on the sorted int64 bounds, one buffer of
points and flags).  Measured, all on the card, at fig3_weak's shapes
(a 256 x 16384 dirty plane; 2W = 512 window bounds):

* each kernel's wrapper time (CUDA events over back-to-back calls), its
  C entry's alone and one launch's device time (torch.profiler); for
  the packed popcount also the path ``popcount_rows(pack_rows(plane))``
  that its callers ran;
* ``RegionDirectory.dirty_counts`` and ``shared_intervals`` on
  'kernels' (``chip_smoke.directory_calls``): the wall of one call and
  its device activities;
* the traced wall and device activities of the two fig2_strong points on
  'kernels' (the unfused flush) and of fig4_spill's spilling point on
  'fused' (batched eviction, ``evict_rows``).

Prints the card line and then one JSON object, also written to
chiprun_out/sweep_probe_<tag>.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
C = 16384


def kernel_calls(torch, np, smoke, ps, dev):
    """name -> {shape, wrapper, C entry, kernel name[, path]} for the two
    kernels at fig3_weak's shapes, for either interface."""
    rng = np.random.default_rng(2013)
    W = smoke.W
    plane = torch.as_tensor(rng.random((W, C)) < 0.5, device=dev)
    starts, ends = smoke.flush_windows(np, np.random.default_rng(3), C)
    bounds = np.stack([np.sort(starts), np.sort(ends)])
    stream = torch.cuda.current_stream().cuda_stream
    entry = ps._KERNELS.entry
    counts = torch.empty(W, dtype=torch.int64, device=dev)
    if hasattr(ps, "_coverage_multi_delta_plain"):      # the bool one
        cover = torch.as_tensor(bounds, device=dev)
        out = torch.empty(4 * W, dtype=torch.int64, device=dev)
        keep = (plane, cover, counts, out)
        return "bool", {
            "popcount_rows": dict(
                shape=[W, C], wrapper=lambda: ps.popcount_rows(plane),
                c_entry=lambda _=keep: entry("popcount_rows")(
                    plane.data_ptr(), C, W, C, counts.data_ptr(), stream)),
            "coverage_multi": dict(
                shape=[2, W], wrapper=lambda: ps.coverage_multi(cover),
                c_entry=lambda _=keep: entry("coverage_multi")(
                    cover.data_ptr(), W, out.data_ptr(), stream)),
        }
    bits = ps.pack_rows(plane)
    pts = bounds.reshape(-1)
    order = np.argsort(pts, kind="stable")
    delta = torch.as_tensor(np.where(order < W, 1, -1).astype(np.int32),
                            device=dev)
    flags = torch.empty(2 * W, dtype=torch.uint8, device=dev)
    keep = (plane, bits, delta, counts, flags)
    return "packed", {
        "popcount_rows": dict(
            shape=[W, C // 32], wrapper=lambda: ps.popcount_rows(bits),
            c_entry=lambda _=keep: entry("popcount_rows")(
                bits.data_ptr(), counts.data_ptr(), W, C // 32, stream),
            path=lambda: ps.popcount_rows(ps.pack_rows(plane))),
        "coverage_multi": dict(
            shape=[2 * W], wrapper=lambda: ps.coverage_multi(delta),
            c_entry=lambda _=keep: entry("coverage_multi")(
                delta.data_ptr(), flags.data_ptr(), 2 * W, stream)),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_probe: torch finds no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    tree = Path(args.src).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import chip_smoke as smoke
    from repro_torch.core import make_runtime
    from repro_torch.dsm import apps
    from repro_torch.dsm.costmodel import IB_2013
    from repro_torch.kernels import protocol_sweep as ps

    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    interface, calls = kernel_calls(torch, np, smoke, ps, dev)
    out = {"card": card, "tree": str(tree), "tag": args.tag,
           "interface": interface, "kernels": {}}
    for name, c in calls.items():
        kernel = f"{name}_kernel"
        row = dict(shape=c["shape"], ms=smoke.timed_ms(torch, c["wrapper"]),
                   c_entry_ms=smoke.timed_ms(torch, c["c_entry"]),
                   profiled_ms=smoke.profiled_ms(torch, c["c_entry"],
                                                 kernel))
        if "path" in c:
            row["path_ms"] = smoke.timed_ms(torch, c["path"])
        out["kernels"][name] = row
    out["directory"] = smoke.directory_calls(torch, np, dev, C)
    runs = [(sec, tag, "kernels", lambda a=app, s=series, m=mode, n=n:
             smoke.run_point(torch, make_runtime, apps, IB_2013, a, s, m, n,
                             "kernels"))
            for sec, tag, series, app, mode, n in smoke.main_points()
            if sec == "fig2_strong"]
    runs += [(pt[0], pt[1], "fused",
              lambda pt=pt: smoke.run_spill_point(torch, pt, "fused"))
             for pt in smoke.spill_points() if pt[1] == "samhita_spills"]
    out["points"] = []
    for sec, tag, backend, run in runs:
        run()                                                # warm
        holder = {}
        n = smoke.device_activities(torch, lambda r=run: holder.update(
            wall=r()[1]))
        out["points"].append(dict(section=sec, series=tag, backend=backend,
                                  device_activities=n,
                                  traced_wall_s=holder["wall"]))
    text = json.dumps(out)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"sweep_probe_{args.tag}.json").write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
