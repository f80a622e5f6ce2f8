"""Rehearsals of whole runs at a tiny size on the CPU: the result line
of each cell, with and without tracing; each fault a cell can have,
planted under its timed path, turning ``correct`` false; the trace's
reduction on made-up events; and the refusal to run without a card."""
from __future__ import annotations

import io
import json

import pytest
import torch

from portbench import run as R
from portbench.harness import card, trace as tr
from portbench.tests.tiny import CELLS, SEED, tiny_cell


def rehearse(workload, trace=False, fault=None, seconds=0.3):
    out = io.StringIO()
    line = R.run(workload, SEED, seconds, trace, device="cpu",
                 cell=tiny_cell(workload), fault=fault, out=out)
    last = out.getvalue().strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(line))
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload):
    line = rehearse(workload)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = tiny_cell(workload)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert set(line["checks"]) == set(cell.limits)
    assert card.forbidden_modules() == []


@pytest.mark.parametrize("workload", CELLS)
def test_traced_result_line(workload):
    line = rehearse(workload, trace=True)
    assert line["correct"] is True
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = tiny_cell(workload)
    names = {m["name"] for m in cell.per_layer}
    # the CPU has no device trace: the kernel rooflines find nothing to
    # read and are left out, never given as 0
    got = set(line["metrics"])
    assert got <= names
    assert {n for n in names if "roofline" not in n} <= got


FAULTS = [("internlm2-train-4k", "unchanged"), ("internlm2-train-4k", "half"),
          ("mamba2-serve-doc2k", "token")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_fails(workload, fault):
    line = rehearse(workload, fault=fault)
    assert line["correct"] is False, line["checks"]


def ev(name, kind, a, b, corr=0):
    return tr.Event(name, kind, a, b, corr)


def test_trace_reduction():
    host = [ev(tr.WINDOW, "user_annotation", 0, 1000),
            ev("portbench.wave", "user_annotation", 0, 1000),
            ev(tr.SPAN_PREFIX + "flash_attention", "user_annotation", 100,
               200),
            ev("cudaLaunchKernel", "cuda_runtime", 120, 130, corr=7),
            ev("cudaLaunchKernel", "cuda_runtime", 300, 310, corr=8),
            ev("aten::item", "cpu_op", 600, 900)]
    dev = [ev("flash_kernel", "kernel", 150, 450, corr=7),
           ev("gemm", "kernel", 400, 500, corr=8),
           ev("copy", "gpu_memcpy", 950, 1100, corr=9)]
    r = tr.reduce(dev, host, ["flash_attention", "ssd_chunk"])
    assert r["window_s"] == pytest.approx(1000e-9)
    # busy: [150, 500] and [950, 1000] inside the window
    assert r["busy_s"] == pytest.approx(400e-9)
    assert r["idle_share"] == pytest.approx(0.6)
    assert r["span_device_s"] == {"flash_attention": pytest.approx(300e-9),
                                  "ssd_chunk": None}
    assert r["breakdown"]["device_ops"][0] == ["flash_kernel",
                                               pytest.approx(300e-9)]
    idle = dict(r["breakdown"]["idle_gaps"])
    # [0, 150) under the wave span, [500, 950) under aten::item
    assert idle == {"portbench.wave": pytest.approx(150e-9),
                    "aten::item": pytest.approx(450e-9)}


def test_kernel_roofline_reader_needs_a_trace():
    from portbench.harness.readers import kernel_roofline
    calls = [(165e12 * 1e-3, 0, torch.float32)]         # 1 ms of work
    rec = {"spans": {"k": calls}, "trace": {"span_device_s": {"k": 4e-3}}}
    assert kernel_roofline(rec, "k") == pytest.approx(25.0)
    rec["trace"]["span_device_s"]["k"] = None
    assert kernel_roofline(rec, "k") is None


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "internlm2-train-4k", "--seed", str(SEED),
                 "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""
