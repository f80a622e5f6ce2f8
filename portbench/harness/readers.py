"""What the per-layer metric files share: each file names its metric
and reads it from a run's record with one of these.

A record holds the ``cell``, the driver's ``window`` summary, the
``trace`` reduction (``harness.trace.reduce``) and the kernel ``spans``'
calls.  A reader that finds nothing to read returns None, and the
metric is left out of the line.
"""
from __future__ import annotations

from . import kernel_work, peaks


def kernel_roofline(record, span: str):
    """A kernel's share of its roofline, in %: the least time of its
    calls' counted work over the device time launched inside its
    spans."""
    calls = record["spans"].get(span)
    device_s = record["trace"]["span_device_s"].get(span)
    if not calls or not device_s:
        return None
    least = sum(kernel_work.least_seconds(f, b, dt) for f, b, dt in calls)
    return 100.0 * least / device_s


def idle_share(record):
    """The share of the traced window with no device activity, in %."""
    return 100.0 * record["trace"]["idle_share"]


def mfu(record):
    """Model FLOPs done in the window over its seconds at the float32
    peak, in %."""
    w = record["window"]
    if not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / (w["seconds"]
                                       * peaks.FLOPS_PER_S["float32"])
