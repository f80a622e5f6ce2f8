"""Blockwise-int8 AdamW state (the port of the reference's
``optim/quantized.py``).

Both moments are stored as int8 with one float32 absmax scale per block
of 128 along the last axis only (scales of shape (..., ceil(L/128))), and
v as sqrt(v), so m and sigma quantize to zero together: ~2.06 bytes a
parameter against 8 for float32 m and v.  The update dequantizes, applies
AdamW and quantizes again.  ``torch.round``, like ``jnp.round``, rounds
half to even, so the codes and scales are the reference's bit for bit on
the same float32 input.

On a rank's blocks (``adamw8bit_update(..., shards=)``, a sharding
context's step) the values are the whole leaf's: where every 128-block
of the last dim lies inside the rank's block and the scales are split
alike, the codes and scales are the local ones; where a block spans
ranks (or the scales' last dim is laid out otherwise), each block's
absmax is the max over the ranks holding parts of it and the rank keeps
its block of the scales, which dequantizing gathers whole.  The codes
and scales are then those of the one-process update, bit for bit.
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


class _Blocks:
    """Quantize and dequantize a rank's block of a leaf whose last dim
    is split over the mesh axes ``ax`` and whose scales' last dim over
    ``sax`` (one-rank axes left out), as the whole leaf would be."""

    def __init__(self, shape, ax, sax, mesh, device):
        self.ax, self.sax, self.mesh = ax, sax, mesh
        n = mesh.size(ax) if ax else 1
        last = shape[-1]
        first = (mesh.block_index(ax) if ax else 0) * last
        self.n_blocks = (last * n + BLOCK - 1) // BLOCK
        # the global 128-block of each of the rank's last-dim entries
        self.idx = (first + torch.arange(last, device=device)) // BLOCK

    def quantize(self, x):
        from repro_torch.models.collectives import own_block, reduce
        amax = torch.zeros(x.shape[:-1] + (self.n_blocks,),
                           dtype=torch.float32, device=x.device)
        amax.scatter_reduce_(-1, self.idx.expand(x.shape), torch.abs(x),
                             "amax")
        amax = reduce(amax, self.ax, self.mesh, op="max")
        scale = amax / 127.0 + 1e-30
        q = torch.clamp(torch.round(x / scale[..., self.idx]), -127,
                        127).to(torch.int8)
        return q, own_block(scale, -1, self.sax, self.mesh).clone(
            memory_format=torch.contiguous_format)

    def dequantize(self, q, scale):
        from repro_torch.models.collectives import gather
        whole = gather(scale, -1, self.sax, self.mesh)
        return q.float() * whole[..., self.idx]


def adamw8bit_update(params, grads, state, step, lr, cfg: AdamWConfig, *,
                     sq_norm=None, shards=None):
    """Drop-in replacement for ``adamw_update`` with int8 m and sqrt(v).
    ``sq_norm``: the gradients' global square norm, if the caller has it.
    ``shards`` = (per leaf (axes of the parameter's last dim, axes of
    its scales' last dim), mesh): ``params``, ``grads`` and ``state``
    are a rank's blocks, updated as the whole leaves would be (see the
    module's note); every rank of the mesh must call it."""
    flat_p = tree_leaves(params)
    dev = flat_p[0].device
    sq = global_sq_norm(grads) if sq_norm is None else sq_norm
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, sq_norm=sq)
    else:
        gnorm = torch.sqrt(sq)
    bc1, bc2 = bias_corrections(step, cfg, dev)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)

    def leaf(p, g, s, axes):
        quant, dequant = quantize_blockwise, dequantize_blockwise
        if axes is not None:
            ax, sax = axes
            local = p.dim() == 0 or (ax == sax and (
                not ax or p.shape[-1] % BLOCK == 0))
            if not local:
                blocks = _Blocks(p.shape, ax, sax, shards[1], p.device)
                quant, dequant = blocks.quantize, blocks.dequantize
        g = g.float()
        m = dequant(s["m_q"], s["m_s"])
        sigma = dequant(s["v_q"], s["v_s"])
        v = sigma * sigma
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        new_p = (p.float() - lr * (upd + wd * p.float())).to(p.dtype)
        m_q, m_s = quant(m)
        v_q, v_s = quant(torch.sqrt(v))
        return new_p, {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}

    # the state's per-parameter dicts, in the parameters' leaf order
    # (``flatten_up_to`` of the reference)
    flat_s = []
    tree_map(lambda p, s: flat_s.append(s), params, state)
    axes = shards[0] if shards is not None else [None] * len(flat_p)
    outs = [leaf(p, g, s, a) for p, g, s, a in zip(
        flat_p, tree_leaves(grads), flat_s, axes)]
    return (tree_unflatten(params, [o[0] for o in outs]),
            tree_unflatten(params, [o[1] for o in outs]), gnorm)


def opt_bytes_per_param() -> float:
    """int8 q (x2) + f32 scale per 128 block (x2) = 2.0625 B/param."""
    return 2.0 + 8.0 / BLOCK
