"""Parameter specs and their seeded initialisation (the reference's
``ParamSpec``, ``init_param`` and ``init_params`` of
``models/sharding.py``).  ``axes`` are the logical axis names of the
dims, which ``models.sharding`` maps to mesh axes.

The rules and scales are the reference's: ``normal`` draws N(0, scale²),
``scaled`` N(0, (scale / sqrt(fan_in))²) with fan_in the last-but-one dim,
``zeros`` and ``ones`` are constants.  The numbers come from a
``torch.Generator`` on the target device, so they differ from the
reference's ``jax.random`` draws; parity tests carry the reference's
weights across instead (``models/carry.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"       # 'normal' | 'zeros' | 'ones' | 'scaled'
    scale: float = 1.0         # stddev for 'normal'; fan-in applied for 'scaled'
    axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def init_param(spec: ParamSpec, generator: torch.Generator,
               dtype: torch.dtype) -> torch.Tensor:
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    std = spec.scale
    if spec.init == "scaled":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale * fan_in ** -0.5
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=dev)
    # scaled in place: a full-width expert stack is ~18 GB in float32
    return draw.mul_(std).to(dtype)


def init_params(spec_tree: Any, generator: torch.Generator,
                dtype: torch.dtype) -> Any:
    """A tree (dicts, lists, tuples) of ParamSpec -> the same tree of
    tensors on the generator's device, drawn in the tree's order with dict
    keys sorted."""
    if isinstance(spec_tree, ParamSpec):
        return init_param(spec_tree, generator, dtype)
    if isinstance(spec_tree, dict):
        return {k: init_params(spec_tree[k], generator, dtype)
                for k in sorted(spec_tree)}
    return type(spec_tree)(init_params(s, generator, dtype)
                           for s in spec_tree)
