"""The reference's model parameters and optimiser state, carried into the
port, and the port's trees carried back.

``params_from_numpy(cfg, tree, device)`` takes the reference's parameter
pytree as numpy arrays (``embed``, ``final_ln``, ``blocks[pos][name]``
stacked on layers, ``lm_head`` unless the embeddings are tied; for
example ``jax.device_get`` of ``repro.models.model.init_model_params``)
and returns the port's parameter dict on ``device``, checked name for
name and shape for shape against ``param_specs(cfg)``.
``opt_state_from_numpy`` does the same for the reference's AdamW state
``{"m": params-tree, "v": params-tree}`` (float32 moments) and
``opt_state_q8_from_numpy`` for its blockwise-int8 state (a dict
``{"m_q", "m_s", "v_q", "v_s"}`` in place of each parameter, codes int8
of the parameter's shape, scales float32 of ``scale_shape``).
``tree_to_numpy`` takes any tree of tensors back to numpy arrays.  With
them both packages run from the same mid-run state.  Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.model import param_specs
from repro_torch.models.params import ParamSpec
from repro_torch.optim.quantized import scale_shape
from repro_torch.utils.tree import tree_map


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


def opt_state_from_numpy(cfg, state, device) -> dict:
    specs, dev = param_specs(cfg), torch.device(device)
    return {k: _carry(specs, state[k], dev, f"opt.{k}") for k in ("m", "v")}


def opt_state_q8_from_numpy(cfg, state, device) -> dict:
    dev = torch.device(device)

    def leaf(spec):
        shapes = {"m_q": spec.shape, "v_q": spec.shape,
                  "m_s": scale_shape(spec.shape),
                  "v_s": scale_shape(spec.shape)}
        return {k: ParamSpec(v) for k, v in shapes.items()}
    return _carry(tree_map(leaf, param_specs(cfg)), state, dev, "opt")


def tree_to_numpy(tree):
    """A tree of tensors (dicts, lists, tuples) as the same tree of numpy
    arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
