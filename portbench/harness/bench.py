"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A workload names a configuration and a traffic mix.  The configuration's
``file`` holds its sizes and names its ``family``, whose plain reference
is ``reference/<family>.py`` and whose link to the program is
``families/<family>.py``.  The traffic mix is ``traffic/<traffic>.json``
and names its ``driver``, ``drivers/<driver>.py``.  The output limits of
a cell are ``limits/<workload>.json``.  A per-layer metric is
``metrics/<name>.py``; it is read in the cells its ``workloads`` list,
or, without that key, in every cell that reports the end-to-end metric
it ``moves``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                   # the checkout


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The module in ``path`` (whose file name may hold dots, as a
    metric's does), imported under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict                 # the configuration file's contents
    traffic_name: str
    traffic: dict                # the traffic file's contents
    limits: dict                 # {check name: limit}
    end_to_end: List[dict]       # entries this cell reports with --trace 0
    per_layer: List[dict]        # entries this cell reports with --trace 1

    @property
    def family(self) -> str:
        return self.config["family"]

    def driver(self) -> ModuleType:
        return load_module(HERE / "drivers" / f"{self.traffic['driver']}.py",
                           f"portbench_driver_{self.traffic['driver']}")

    def program(self) -> ModuleType:
        return load_module(HERE / "families" / f"{self.family}.py",
                           f"portbench_family_{self.family}")

    def reference(self) -> ModuleType:
        return load_module(HERE / "reference" / f"{self.family}.py",
                           f"portbench_reference_{self.family}")

    def metric_modules(self) -> Dict[str, ModuleType]:
        return {m["name"]: metric_module(m["name"]) for m in self.per_layer}


def metric_module(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "__"))


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(entry: dict, workload: str) -> bool:
    """Whether an end-to-end metric ``entry`` is reported in ``workload``."""
    return "workloads" not in entry or workload in entry["workloads"]


def cell(workload: str, root: Path = ROOT, spec: dict = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of ``spec``)."""
    spec = spec or benchmark(root)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if reports(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    limits_path = HERE / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=w["chips"], config_name=w["config"],
        config=load_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path)["limits"],
        end_to_end=e2e, per_layer=per_layer)
