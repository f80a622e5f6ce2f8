"""The reference's model parameters, carried into the port.

``params_from_numpy(cfg, tree, device)`` takes the reference's parameter
pytree as numpy arrays (``embed``, ``final_ln``, ``blocks[pos][name]``
stacked on layers, ``lm_head`` unless the embeddings are tied; for
example ``jax.device_get`` of ``repro.models.model.init_model_params``)
and returns the port's parameter dict on ``device``, checked name for
name and shape for shape against ``param_specs(cfg)``.  Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.model import param_specs
from repro_torch.models.params import ParamSpec


def _carry(spec: Any, arr: Any, device, where: str):
    if isinstance(spec, ParamSpec):
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{where}: shape {a.shape} != {spec.shape}")
        return torch.from_numpy(np.array(a)).to(device)
    if isinstance(spec, dict):
        if set(spec) != set(arr):
            raise ValueError(f"{where}: keys {sorted(arr)} != "
                             f"{sorted(spec)}")
        return {k: _carry(spec[k], arr[k], device, f"{where}.{k}")
                for k in spec}
    if len(spec) != len(arr):
        raise ValueError(f"{where}: {len(arr)} entries != {len(spec)}")
    return [_carry(s, a, device, f"{where}[{i}]")
            for i, (s, a) in enumerate(zip(spec, arr))]


def params_from_numpy(cfg, tree, device) -> dict:
    return _carry(param_specs(cfg), tree, torch.device(device), "params")
