"""Tiny cells for the benchmark's CPU tests: each workload of
``BENCHMARK.json`` with its configuration and traffic cut to a size the
CPU runs in seconds (the widths, depth, vocabulary and lengths below);
the drivers, the references and the checks are the benchmark's own."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "internlm2-1.8b": dict(hidden_size=64, intermediate_size=128,
                           num_attention_heads=4, num_key_value_heads=2,
                           num_hidden_layers=2, vocab_size=256),
    "mamba2-2.7b": dict(d_model=64, n_layer=2, vocab_size=256, token_ids=250,
                        ssm_cfg={"layer": "Mamba2", "d_state": 16,
                                 "d_conv": 4, "expand": 2, "headdim": 16,
                                 "ngroups": 1, "chunk_size": 32}),
}
TINY_TRAFFIC = {
    "train-2x4k": dict(seq=64),
    "doc2k-w16": dict(batch=4, prompt_min=40, prompt_max=80, new_tokens=4,
                      check_requests=4, calibrate_waves=2),
}
CELLS = ("internlm2-train-4k", "mamba2-serve-doc2k")   # BENCHMARK.json's
SEED = (1 << 31) + 17       # past 32 signed bits, as the driver's are


def full_cell(workload: str, config: str = None):
    """The cell ``workload`` of ``BENCHMARK.json``; with ``config``,
    another of its configurations under the cell's traffic."""
    from portbench.harness import bench
    cell = bench.cell(workload)
    if config is not None:
        conf = {c["name"]: c for c in bench.benchmark()["configs"]}[config]
        cell.config_name = config
        cell.config = bench.load_json(ROOT / conf["file"])
    return cell


def tiny_cell(workload: str, config: str = None):
    cell = full_cell(workload, config)
    cell.config = {**cell.config, **TINY_CONFIGS[cell.config_name]}
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic_name]}
    return cell
