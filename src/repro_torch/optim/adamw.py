"""AdamW with float32 moments, decoupled weight decay and global-norm
clipping (the port of the reference's ``optim/adamw.py``).  The optimiser
state is a tree of the parameters' structure, ``{"m": ..., "v": ...}``.

Every scalar of the update is a float32 tensor on the parameters' device,
as in the reference, where the step is a float32 array: the bias
corrections ``1 - b ** t`` and the schedule are computed in float32, not
in Python's float64, so they keep the reference's last bits.  The update
is functional: it returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.utils.tree import (
    global_sq_norm, tree_leaves, tree_map, tree_unflatten, tree_zeros_like,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def init_opt_state(params):
    return {
        "m": tree_zeros_like(params, torch.float32),
        "v": tree_zeros_like(params, torch.float32),
    }


def _f32(x, device=None) -> torch.Tensor:
    """A step, rate or norm as a float32 tensor (0-d for a number)."""
    if torch.is_tensor(x):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def clip_by_global_norm(grads, max_norm, *, sq_norm=None):
    """Returns (grads scaled to at most ``max_norm``, the norm before).
    ``sq_norm`` may be supplied by the caller."""
    if sq_norm is None:
        sq_norm = global_sq_norm(grads)
    norm = torch.sqrt(sq_norm)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def bias_corrections(step, cfg: AdamWConfig, device):
    """(1 - b1 ** t, 1 - b2 ** t) in float32, t = step + 1."""
    t = _f32(step, device) + 1.0
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=device)
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def adamw_update(params, grads, state, step, lr, cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm)."""
    flat_p = tree_leaves(params)
    dev = flat_p[0].device
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = torch.sqrt(global_sq_norm(grads))
    bc1, bc2 = bias_corrections(step, cfg, dev)
    lr = _f32(lr, dev)

    def upd(p, g, m, v):
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * (g * g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decay only the matrices (the reference's ``_decay_mask``)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        delta = delta + wd * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    outs = [upd(*leaves) for leaves in zip(
        flat_p, tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new = [tree_unflatten(params, [o[i] for o in outs]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2]}, gnorm


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """Linear warmup over ``warmup`` steps, then a cosine from ``base_lr``
    to ``min_frac * base_lr`` at ``total``: a float32 0-d tensor of the
    step (an int or a tensor), in the reference's float32 order."""
    def sched(step, device=None):
        step = _f32(step, device)
        warm = base_lr * (step + 1.0) / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched
