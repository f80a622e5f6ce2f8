#!/usr/bin/env python3
"""Time the rank-select kernels and the refetch replay's victim scan of
one tree's ``repro_torch`` on a CUDA card, so that two trees can be
compared inside one call (run it once per tree, in turns).

    python3 rank_select_probe.py [--src DIR] [--tag NAME]

DIR is the root of a checkout (default: the one holding this script);
its ``src/repro_torch`` is imported and its CUDA sources are built into
DIR/build.  The probe takes either rank-select interface of the port:
the packed one (int32 words in: the caller packs the run with pack_rows
and unpacks the take mask) or the bool-plane one (bool run planes in,
the bool take mask out, ``take_run`` for one run read back in one
copy).  Measured, all on the card:

* take_first_k, kth_set_index and take_and_cut at the lru_take shape
  (256 runs of 32768 columns, random ranks) and at one run of 7 columns
  with 5 live cells and k = 1 (the commonest victim scan of the smoke's
  spill phase; the rank by value where the interface takes one, as the
  replay passes it): the wrapper's time (CUDA events over back-to-back
  calls), the C entry's alone, and one launch's device time
  (torch.profiler); for the packed interface the wrapper's time includes
  neither pack_rows nor unpack_rows, which the caller runs;
* one victim scan as ``RegionDirectory.take_upto_row`` makes it on
  'fused' and on 'kernels', from the host's live mask to the victim
  columns on the host: its wall (host clock, each scan ends on the
  host's read) and the device activities of one traced scan;
* the device activities of traced fig4_refetch and fig7_md_spill runs
  on 'fused' (the smoke's spill points).

Prints the card line and then one JSON object, also written to
chiprun_out/rank_select_probe_<tag>.json.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the commonest victim scan of the smoke's spill phase: 7 columns, 5 live
RUN = (True, False, True, True, False, True, True)
RUN_K = 1
LRU = (256, 32768)


def entry_calls(torch, smoke, ps, live, k):
    """name -> (wrapper call, C entry call) of the three entries on bool
    ``live`` (R, C) with ranks ``k`` (an int32 vector on the card, or an
    int for one row), for either interface; the packed one takes the
    words ``pack_rows`` makes of ``live``, and a rank vector."""
    if hasattr(ps, "take_run"):
        return smoke.rank_entry_calls(torch, ps, live, k)
    stream = torch.cuda.current_stream().cuda_stream
    R = live.shape[0]
    if isinstance(k, int):
        k = torch.tensor([k], dtype=torch.int32, device=live.device)
    entry = ps._KERNELS.entry
    bits = ps.pack_rows(live)
    nw = bits.shape[1]
    take = torch.empty_like(bits)
    cut = torch.empty(R, dtype=torch.int64, device=live.device)
    b, kp, tp, cp = (bits.data_ptr(), k.data_ptr(), take.data_ptr(),
                     cut.data_ptr())
    keep = (bits, k, take, cut)      # the tensors behind the pointers
    return {
        "take_first_k": (
            lambda: ps.take_first_k(bits, k),
            lambda _=keep: entry("take_first_k")(b, kp, tp, R, nw, stream)),
        "kth_set_index": (
            lambda: ps.kth_set_index(bits, k),
            lambda _=keep: entry("kth_set_index")(b, kp, cp, R, nw,
                                                  stream)),
        "take_and_cut": (
            lambda: ps.take_and_cut(bits, k),
            lambda _=keep: entry("take_and_cut")(b, kp, tp, cp, R, nw,
                                                 stream)),
    }


def victim_scan(torch, d, live):
    """One victim scan as the refetch replay makes it: the host mask to
    the card, the rank-select, the victim columns and cut on the host."""
    got, cut = d.take_upto_row(torch.as_tensor(live, device=d.device),
                               RUN_K)
    if isinstance(got, torch.Tensor):               # a device take mask
        got = torch.nonzero(got).flatten().cpu().numpy()
    return got, cut


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rank_select_probe: torch finds no CUDA device",
              file=sys.stderr)
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
    from repro_torch.core.directory import RegionDirectory
    from repro_torch.kernels import protocol_sweep as ps

    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    out = {"card": card, "tree": str(tree), "tag": args.tag,
           "interface": "bool" if hasattr(ps, "take_run") else "packed",
           "kernels": {}}
    shapes = {"lru": torch.as_tensor(rng.random(LRU) < 0.5, device=dev),
              "run": torch.as_tensor(np.array([RUN]), device=dev)}
    ranks = {"lru": torch.as_tensor(rng.integers(0, LRU[1], LRU[0]),
                                    dtype=torch.int32, device=dev),
             "run": RUN_K}
    for key, live in shapes.items():
        for name, (wrapper, c_entry) in entry_calls(
                torch, smoke, ps, live, ranks[key]).items():
            out["kernels"].setdefault(name, {})[key] = dict(
                shape=list(live.shape),
                ms=smoke.timed_ms(torch, wrapper),
                c_entry_ms=smoke.timed_ms(torch, c_entry),
                profiled_ms=smoke.profiled_ms(torch, c_entry,
                                              "rank_select_kernel"))
    live = np.array(RUN)
    nz = np.flatnonzero(live)
    want = nz[:RUN_K], int(nz[RUN_K - 1]) + 1
    out["victim_scan"] = {}
    for backend in ("fused", "kernels"):
        d = RegionDirectory(1, 0, 0, 64, backend=backend, device=dev)
        cols, cut = victim_scan(torch, d, live)
        if list(cols) != list(want[0]) or cut != want[1]:
            raise AssertionError(f"victim scan [{backend}]: {cols}, {cut} "
                                 f"!= {want}")
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                victim_scan(torch, d, live)
            walls.append((time.perf_counter() - t0) / 200 * 1e3)
        out["victim_scan"][backend] = dict(
            run=[len(RUN), RUN_K], wall_ms=statistics.median(walls),
            device_activities=smoke.device_activities(
                torch, lambda: victim_scan(torch, d, live)))
    out["spill_points"] = {}
    for pt in smoke.spill_points():
        if pt[0] in ("fig4_refetch", "fig7_md_spill"):
            smoke.run_spill_point(torch, pt, "fused")       # warm
            holder = {}
            n = smoke.device_activities(torch, lambda: holder.update(
                wall=smoke.run_spill_point(torch, pt, "fused")[1]))
            out["spill_points"][pt[0]] = dict(device_activities=n,
                                              traced_wall_s=holder["wall"])
    text = json.dumps(out)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"rank_select_probe_{args.tag}.json").write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
