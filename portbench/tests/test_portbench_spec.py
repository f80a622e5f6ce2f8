"""The harness finds every configuration, traffic mix, driver, reference,
limit file and per-layer metric by the names ``BENCHMARK.json`` gives,
and ``BENCHMARK.json`` keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import bench
from portbench.tests.tiny import CELLS, ROOT, full_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_workloads_listed_are_the_cells():
    assert tuple(w["name"] for w in SPEC["workloads"]) == CELLS
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lengths(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert bench.reports(e2e[m["moves"]], w)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = full_cell(workload)
    assert cell.config["name"] == cell.config_name
    driver = cell.driver()
    for fn in ("setup", "window", "check", "calibrate"):
        assert callable(getattr(driver, fn))
    assert callable(cell.reference().layout)
    assert callable(cell.program().program_config)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for name, mod in cell.metric_modules().items():
        assert callable(mod.read), name


@pytest.mark.parametrize("name", sorted(
    p.name[:-3] for p in (ROOT / "portbench" / "metrics").glob("*.py")))
def test_every_metric_file_loads(name):
    mod = bench.metric_module(name)
    assert callable(mod.read)
    for span in getattr(mod, "SPANS", ()):
        assert len(span) == 4 and callable(span[3])


@pytest.mark.parametrize("workload", CELLS)
def test_program_layout_is_the_reference_layout(workload):
    """The port's parameter tree at the configuration's full size has the
    leaves and shapes the benchmark draws (shapes only; nothing made)."""
    from portbench.harness.context import check_layout
    cell = full_cell(workload)
    cfg = cell.program().program_config(cell.config)
    check_layout(cfg, cell.reference().layout(cell.config))
    from portbench.harness.weights import count
    want = {"internlm2-1.8b": 1_889_110_016, "mamba2-2.7b": 2_831_336_960}
    assert count(cell.reference().layout(cell.config)) == \
        want[cell.config_name]


def test_config_files_are_under_paths_and_distinct():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).is_file()
