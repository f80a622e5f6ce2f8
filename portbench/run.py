"""Run one cell of the benchmark on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

With ``--trace 0`` the result line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics (the window under
torch.profiler, kernel spans installed), ``device.busy_s``,
``device.window_s`` and a ``breakdown``.  Either way the run checks the
window's output against the plain reference once the window has closed
and prints each number compared beside its limit.  Without a card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result.

``--calibrate N`` (not a benchmark run) reads the check's numbers on N
seeds from ``--seed`` on, and on the first ``--control-seeds`` of them
the control's and the planted faults', one seed after another in one
process, for setting the limits; it prints one JSON line a seed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import bench, card, trace as tr  # noqa: E402
from portbench.harness.checks import judge  # noqa: E402
from portbench.harness.context import Ctx, log  # noqa: E402
from portbench.harness.result import emit  # noqa: E402


def start(device=None, chips=1):
    """Import torch with the caches set, find the card(s) and set float32
    products to float32; returns (torch, device)."""
    card.prepare_env(ROOT)
    import torch
    if device is None:
        card.require_cards(torch, chips)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    card.float32_settings(torch, tf32=False)
    return torch, torch.device(device)


def metric_spans(cell) -> list:
    """The kernel spans the cell's per-layer metrics read: (name, module,
    attribute, work function) from each metric module's ``SPANS``."""
    import importlib
    out = []
    for mod in cell.metric_modules().values():
        for name, module, attr, work in getattr(mod, "SPANS", ()):
            out.append((name, importlib.import_module(module), attr, work))
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device=None, cell=None, fault=None, out=None) -> dict:
    """One run; returns the result line it printed.  ``device``, ``cell``
    and ``fault`` are for rehearsals (a CPU device, a cut cell, a planted
    fault); a benchmark run gives none of them."""
    cell = cell or bench.cell(workload)
    torch, dev = start(device, cell.chips)
    ctx = Ctx(torch=torch, device=dev, cell=cell, seed=seed, fault=fault)
    driver = cell.driver()
    state = driver.setup(ctx)
    spans = tr.KernelSpans(torch)
    span_names = []
    if trace:
        for name, module, attr, work in metric_spans(cell):
            spans.install(name, module, attr, work)
            span_names.append(name)
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s")

    def timed():
        with torch.profiler.record_function(tr.WINDOW):
            return driver.window(ctx, state, seconds)
    if trace:
        win, (dev_ev, host_ev) = tr.profiled(torch, timed)
        spans.uninstall()
        reduced = tr.reduce(dev_ev, host_ev, span_names)
    else:
        win, reduced = timed(), None
    log(f"window {win['seconds']:.3f} s, {win['attempted']} attempted")
    device_rec = card.device_record(torch, dev, cell.chips)
    launches = kernel_launches()
    if launches:
        log(f"kernel launches: {launches}")
    t_check = time.perf_counter()
    numbers = driver.check(ctx, state)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct, checks = judge(numbers, cell.limits)
    if trace:
        device_rec["busy_s"] = reduced["busy_s"]
        device_rec["window_s"] = reduced["window_s"]
        record = {"cell": cell, "window": win, "trace": reduced,
                  "spans": spans.calls}
        metrics = {}
        for m in cell.per_layer:
            value = bench.metric_module(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = reduced["breakdown"]
    else:
        metrics = {}
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s"
                     else win["e2e"].get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = None
        # the per-layer metrics that need no trace, read without the
        # profiler's overhead: beside the traced run's, for comparison
        for m in cell.per_layer:
            if m["source"] != "device_trace":
                value = bench.metric_module(m["name"]).read(
                    {"cell": cell, "window": win})
                log(f"untraced {m['name']} {value!r}")
    found = card.forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        raise SystemExit(3)
    return emit(correct, win["attempted"], win["failed"], metrics,
                device_rec, checks, breakdown, out=out)


def kernel_launches() -> dict:
    """The port's model kernels' launch counters (read to confirm that the
    cell's kernel ran; not a metric)."""
    out = {}
    for mod in ("flash_attention", "ssd_chunk"):
        m = sys.modules.get(f"repro_torch.kernels.{mod}")
        if m is not None:
            out.update({k: v for k, v in m.LAUNCHES.items() if v})
    return out


def calibrate(workload: str, seed: int, n: int, n_control: int,
              device=None, cell=None, out=None):
    cell = cell or bench.cell(workload)
    torch, dev = start(device, cell.chips)
    driver = cell.driver()
    out = out or sys.stdout
    for i in range(n):
        s = seed + i
        t0 = time.perf_counter()
        ctx = Ctx(torch=torch, device=dev, cell=cell, seed=s)
        state = driver.setup(ctx)
        if cell.traffic["driver"] == "serve":
            driver.window(ctx, state,
                          waves=cell.traffic["calibrate_waves"])
        got = driver.calibrate(ctx, state, control=i < n_control)
        del state
        ctx.free()
        out.write(json.dumps({"workload": workload, "seed": s,
                              "seconds": time.perf_counter() - t0,
                              **got}) + "\n")
        out.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", type=int, default=0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    try:
        if args.calibrate:
            calibrate(args.workload, args.seed, args.calibrate,
                      args.control_seeds)
            return 0
        seconds = args.seconds
        if seconds is None:
            seconds = bench.benchmark()["run_seconds"]
        run(args.workload, args.seed, seconds, bool(args.trace))
    except card.NoCard as e:
        log(f"no result: {e}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
