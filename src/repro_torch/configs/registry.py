"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shapes_for, reduce_config

ARCH_IDS = (
    "jamba-1.5-large-398b",
    "moonshot-v1-16b-a3b",
    "grok-1-314b",
    "musicgen-medium",
    "qwen2-vl-72b",
    "mamba2-2.7b",
    "internlm2-1.8b",
    "gemma2-27b",
    "llama3-405b",
    "granite-20b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> Dict[str, tuple]:
    """Every runnable (arch x shape) dry-run cell."""
    return {a: shapes_for(get_config(a)) for a in ARCH_IDS}


def get_reduced(arch: str, **kw) -> ModelConfig:
    return reduce_config(get_config(arch), **kw)
