"""Plain AdamW as the training traffic states it: the gradient clipped
to a global norm, moments ``b1`` and ``b2`` with bias correction,
``eps`` added to the root of the second moment, decoupled weight decay
on the leaves of two or more dimensions (the stacked layout's matrices
and per-layer norms; the final norm is not decayed), and a learning
rate warmed up linearly over ``warmup`` steps, then a cosine down to
``min_lr_frac`` of it at ``total_steps``.

The textbook update, each moment and the step formed from whole terms
(``m = b1 m + (1 - b1) g``, not an in-place axpy), with the step count,
the bias corrections and the rate in float32, as optax and the JAX
training loops this configuration comes from compute them: a float64
rate would move each parameter by a few float32 ulps of its change
more than the published update does.

Leaves are a dict of path -> float32 tensor.  Step ``t`` counts from 0.
"""
from __future__ import annotations

import math

import torch


def learning_rate(hp, t: int, device=None) -> torch.Tensor:
    """The rate at step ``t``, a float32 0-d tensor."""
    f32 = dict(dtype=torch.float32, device=device)
    step = torch.tensor(float(t), **f32)
    warm = hp["lr"] * (step + 1.0) / max(hp["warmup"], 1)
    prog = torch.clamp((step - hp["warmup"])
                       / max(hp["total_steps"] - hp["warmup"], 1), 0.0, 1.0)
    frac = hp["min_lr_frac"]
    cos = hp["lr"] * (frac + (1 - frac) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < hp["warmup"], warm, cos)


@torch.no_grad()
def step(hp, params, grads, m, v, t: int):
    """One update in place of ``params``, ``m`` and ``v``; returns the
    clipped gradients (the gradient as the update takes it)."""
    dev = next(iter(params.values())).device
    f32 = dict(dtype=torch.float32, device=dev)
    sq = sum((g.double() ** 2).sum() for g in grads.values())
    norm = torch.sqrt(sq).to(torch.float32)
    scale = torch.clamp(hp["clip_norm"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    lr = learning_rate(hp, t, dev)
    n = torch.tensor(float(t + 1), **f32)
    bc1 = 1.0 - torch.tensor(hp["b1"], **f32) ** n
    bc2 = 1.0 - torch.tensor(hp["b2"], **f32) ** n
    clipped = {}
    for k, p in params.items():
        g = grads[k] * scale
        clipped[k] = g
        m[k] = hp["b1"] * m[k] + (1.0 - hp["b1"]) * g
        v[k] = hp["b2"] * v[k] + (1.0 - hp["b2"]) * (g * g)
        upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + hp["eps"])
        if p.dim() >= 2:
            upd = upd + hp["weight_decay"] * p
        p.copy_(p - lr * upd)
    return clipped
