"""The result line: one JSON object as the last line of standard output,
its ``checks`` (each number compared, with its limit) as the last key,
and the same numbers as the last lines of standard error."""
from __future__ import annotations

import json
import sys


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown: dict = None,
         out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        err.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    err.flush()
    out.write(json.dumps(line) + "\n")
    out.flush()
    return line
