"""Blockwise-int8 AdamW state (the port of the reference's
``optim/quantized.py``).

Both moments are stored as int8 with one float32 absmax scale per block
of 128 along the last axis only (scales of shape (..., ceil(L/128))), and
v as sqrt(v), so m and sigma quantize to zero together: ~2.06 bytes a
parameter against 8 for float32 m and v.  The update dequantizes, applies
AdamW and quantizes again.  ``torch.round``, like ``jnp.round``, rounds
half to even, so the codes and scales are the reference's bit for bit on
the same float32 input.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import (
    AdamWConfig, bias_corrections, clip_by_global_norm,
)
from repro_torch.utils.tree import (
    global_sq_norm, tree_leaves, tree_map, tree_unflatten,
)

BLOCK = 128


def _last_pad(last: int) -> int:
    return (-last) % BLOCK


def scale_shape(shape) -> Tuple[int, ...]:
    if not shape:
        return (1,)
    last = int(shape[-1])
    return tuple(shape[:-1]) + ((last + BLOCK - 1) // BLOCK,)


def quantize_blockwise(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., L) float32 -> (q int8 of x's shape, scales float32
    (..., ceil(L/128))).  Blocks run along the last axis only."""
    if x.dim() == 0:
        q, s = quantize_blockwise(x[None])
        return q[0], s
    last = x.shape[-1]
    pad = _last_pad(last)
    xb = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=-1) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127).to(
        torch.int8)
    q = q.reshape(*x.shape[:-1], last + pad)[..., :last]
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    if q.dim() == 0:
        return dequantize_blockwise(q[None], scale)[0]
    last = q.shape[-1]
    pad = _last_pad(last)
    qb = F.pad(q, (0, pad)).reshape(*q.shape[:-1], -1, BLOCK).float()
    out = qb * scale[..., None]
    return out.reshape(*q.shape[:-1], last + pad)[..., :last]


def init_opt_state_q8(params):
    def leaf(p):
        return {
            "m_q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "m_s": torch.zeros(scale_shape(p.shape), dtype=torch.float32,
                               device=p.device),
            "v_q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "v_s": torch.zeros(scale_shape(p.shape), dtype=torch.float32,
                               device=p.device),
        }
    return tree_map(leaf, params)


def adamw8bit_update(params, grads, state, step, lr, cfg: AdamWConfig):
    """Drop-in replacement for ``adamw_update`` with int8 m and sqrt(v)."""
    flat_p = tree_leaves(params)
    dev = flat_p[0].device
    sq = global_sq_norm(grads)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, sq_norm=sq)
    else:
        gnorm = torch.sqrt(sq)
    bc1, bc2 = bias_corrections(step, cfg, dev)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)

    def leaf(p, g, s):
        g = g.float()
        m = dequantize_blockwise(s["m_q"], s["m_s"])
        sigma = dequantize_blockwise(s["v_q"], s["v_s"])
        v = sigma * sigma
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        new_p = (p.float() - lr * (upd + wd * p.float())).to(p.dtype)
        m_q, m_s = quantize_blockwise(m)
        v_q, v_s = quantize_blockwise(torch.sqrt(v))
        return new_p, {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}

    # the state's per-parameter dicts, in the parameters' leaf order
    # (``flatten_up_to`` of the reference)
    flat_s = []
    tree_map(lambda p, s: flat_s.append(s), params, state)
    outs = [leaf(p, g, s) for p, g, s in zip(flat_p, tree_leaves(grads),
                                              flat_s)]
    return (tree_unflatten(params, [o[0] for o in outs]),
            tree_unflatten(params, [o[1] for o in outs]), gnorm)


def opt_bytes_per_param() -> float:
    """int8 q (x2) + f32 scale per 128 block (x2) = 2.0625 B/param."""
    return 2.0 + 8.0 / BLOCK
