"""The traced run: kernel spans recorded from the benchmark's own files,
``torch.profiler`` over the window, and the reduction of its raw events
to the device's busy time, its idle gaps named by the host's activity,
the device operations that took most time, and the device time of the
work launched inside each kernel span.

A kernel span wraps the name a layer imports (``repro_torch.models.
layers.flash_attention``, say) with a ``record_function`` range and
counts the call's work from its operands' shapes.  The device time of a
span is that of every device activity whose launch (a CUDA runtime or
driver call, matched by correlation id) lies inside one of its ranges,
so the share reads the same work whatever kernel implements the call.

The raw kineto events are read directly: building ``prof.events()``'s
tree of host ops takes tens of seconds for a window of this size.
"""
from __future__ import annotations

import bisect
import heapq
from typing import Callable, Dict, List, NamedTuple, Optional

SPAN_PREFIX = "portbench.span."
WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


class Event(NamedTuple):
    name: str
    kind: str        # kineto's activity type
    start: int       # ns
    end: int         # ns
    corr: int


class KernelSpans:
    """Wrappers installed on module attributes for the traced run, each
    recording its calls' ``(flops, bytes, dtype)``."""

    def __init__(self, torch):
        self.torch = torch
        self.calls: Dict[str, List[tuple]] = {}
        self._saved = []

    def install(self, name: str, module, attr: str, work: Callable):
        if name in self.calls:
            return
        orig = getattr(module, attr)
        calls = self.calls.setdefault(name, [])
        record_function = self.torch.profiler.record_function
        label = SPAN_PREFIX + name

        def wrapped(*args, **kwargs):
            calls.append(work(*args, **kwargs))
            with record_function(label):
                return orig(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._saved.append((module, attr, orig))

    def uninstall(self):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved.clear()


def raw_events(prof) -> tuple:
    """(device activities, host events) of a finished profile, as
    ``Event`` tuples."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        ev = Event(e.name(), kind, e.start_ns(), e.end_ns(),
                   int(e.correlation_id()))
        if e.device_type() == DeviceType.CUDA:
            if kind in DEVICE_KINDS or (not kind and not
                                        ev.name.startswith("portbench.")):
                dev.append(ev)
        else:
            host.append(ev)
    return dev, host


def merged(intervals) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def window_of(host: List[Event], dev: List[Event]) -> tuple:
    spans = [(e.start, e.end) for e in host if e.name == WINDOW]
    if spans:
        return min(a for a, _ in spans), max(b for _, b in spans)
    if not dev:
        raise ValueError("no window span and no device activity")
    return min(e.start for e in dev), max(e.end for e in dev)


def name_gaps(gaps: List[tuple], host: List[Event]) -> List[str]:
    """For each (start, end) gap, the innermost host event (the latest
    started) running at its midpoint, or ``"no host event"``."""
    evs = sorted((e.start, e.end, e.name) for e in host
                 if e.kind not in LAUNCH_KINDS)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    names = [""] * len(gaps)
    heap: list = []
    j = 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(evs) and evs[j][0] <= mid:
            heapq.heappush(heap, (-evs[j][0], evs[j][1], evs[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        names[i] = heap[0][2] if heap else "no host event"
    return names


def span_device_seconds(dev: List[Event], host: List[Event],
                        span: str) -> Optional[float]:
    """Device seconds of the activities launched inside the host ranges
    named ``SPAN_PREFIX + span``; None when there is no such range or no
    activity launched in one."""
    ranges = merged((e.start, e.end) for e in host
                    if e.name == SPAN_PREFIX + span)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    corr = set()
    for e in host:
        if e.kind in LAUNCH_KINDS or (not e.kind
                                      and e.name.startswith("cu")):
            i = bisect.bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= ranges[i][1] and e.corr:
                corr.add(e.corr)
    secs = sum(e.end - e.start for e in dev if e.corr in corr) * 1e-9
    return secs if corr and secs > 0 else None


def reduce(dev: List[Event], host: List[Event], spans=()) -> dict:
    """The traced window's numbers: ``window_s``, ``busy_s`` (the union
    of device activities inside it), ``idle_share``, the ``breakdown``
    (top 10 device operations by time; idle seconds by the host
    activity at each gap, top 10) and each span's device seconds."""
    w0, w1 = window_of(host, dev)
    inside = [(max(e.start, w0), min(e.end, w1)) for e in dev
              if e.end > w0 and e.start < w1]
    busy = merged(inside)
    busy_ns = sum(b - a for a, b in busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: Dict[str, float] = {}
    for (a, b), name in zip(gaps, name_gaps(gaps, host)):
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    ops: Dict[str, float] = {}
    for e in dev:
        ops[e.name] = ops.get(e.name, 0.0) + (e.end - e.start) * 1e-9
    window_s = (w1 - w0) * 1e-9
    return {
        "window_s": window_s,
        "busy_s": busy_ns * 1e-9,
        "idle_share": 1.0 - busy_ns / max(w1 - w0, 1),
        "device_activities": len(inside),
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]],
        },
        "span_device_s": {s: span_device_seconds(dev, host, s)
                          for s in spans},
    }


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler (host and device activities) and
    return (its result, the reduction's raw events (dev, host))."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return out, raw_events(prof)
