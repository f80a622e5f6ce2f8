"""RegC as gradient synchronisation (the port of the reference's
``regc_sync/policies.py``): the paper's consistency machinery mapped onto
data-parallel training over the ranks of a ``torch.distributed`` world.

* **ordinary-region state**, the bulk gradients, is propagated lazily:
  accumulated locally over microbatches and synced once at the step
  barrier (``ordinary_sync='lazy'``); ``'eager'`` syncs every
  microbatch, the release-consistency baseline;
* **consistency-region state**, small hot objects (the loss), goes
  through ``span_reduce``, the paper's reduction extension (§V-B): one
  all-reduce of the object.

The barrier sync moves one all-reduce a parameter (``granularity=
'object'``, samhita's fine grain) or one a bucket of parameters
concatenated in leaf order (``'bucket'``, samhita_page's pages), and with
``compression='int8_ring'`` runs a ring all-reduce that moves int8 codes
and a float32 scale each hop instead of the float32 values.

The collectives run in the process groups of the ``launch.mesh.Mesh``
given as ``mesh=``, which play the reference's ``shard_map`` axes.  Each
collective call counts, by kind, the bytes this rank sends (the
operand's size) and one message in
``COLLECTIVE_BYTES`` / ``COLLECTIVE_MSGS``, the reference's HLO counts
(``all-reduce``, ``collective-permute``); ``reset_collectives`` zeroes
them.  The ranks run gloo, which takes only host tensors (a card's
pointer handed to its TCP transport fails), so every collective of a
card's tensor stages the payload to the host and back explicitly,
counted in ``STAGED`` (bytes copied either way, and messages).  While
``SYNC_WALLS`` is a list, each ``barrier_sync_grads`` appends its host
wall, the device synchronised before and after.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

KINDS = ("all-reduce", "collective-permute")
COLLECTIVE_BYTES = dict.fromkeys(KINDS, 0)
COLLECTIVE_MSGS = dict.fromkeys(KINDS, 0)
STAGED = {"bytes": 0, "messages": 0}
SYNC_WALLS: Optional[List[float]] = None


def reset_collectives():
    for d in (COLLECTIVE_BYTES, COLLECTIVE_MSGS):
        d.update(dict.fromkeys(KINDS, 0))
    STAGED.update(bytes=0, messages=0)


def _count(kind: str, t: torch.Tensor):
    COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()
    COLLECTIVE_MSGS[kind] += 1


@dataclasses.dataclass(frozen=True)
class RegCSyncPolicy:
    ordinary_sync: str = "lazy"          # 'lazy' (RegC) | 'eager' (RC baseline)
    granularity: str = "bucket"          # 'bucket' (page-like) | 'object' (fine)
    bucket_bytes: int = 64 << 20
    compression: Optional[str] = None    # None | 'int8_ring'

    def __post_init__(self):
        assert self.ordinary_sync in ("lazy", "eager")
        assert self.granularity in ("bucket", "object")
        assert self.compression in (None, "int8_ring")


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` goes through the host (a card's
    tensor); counts the copies."""
    if dist.get_backend(group) != "gloo":
        raise RuntimeError(f"the ranks run {dist.get_backend(group)}; the "
                           "sync is written for gloo")
    if not t.is_cuda:
        return False
    STAGED["bytes"] += 2 * t.numel() * t.element_size()
    STAGED["messages"] += 1
    return True


def _all_reduce(x: torch.Tensor, axes, op: str, mesh):
    """A reduced copy of ``x`` over the ranks of ``axes`` (``x`` kept)."""
    group, _ = mesh.group(axes)
    _count("all-reduce", x)
    if _staged(x, group):
        out = x.cpu()
        dist.all_reduce(out, _OPS[op], group=group)
        return out.to(x.device)
    out = x.clone()
    dist.all_reduce(out, _OPS[op], group=group)
    return out


def _permute(t: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """One hop of a cyclic permute: ``t`` to rank ``dst``, the tensor of
    rank ``src`` back."""
    _count("collective-permute", t)
    stage = _staged(t, group)
    send = t.cpu() if stage else t.contiguous()
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        work.wait()
    return recv.to(t.device) if stage else recv


# ---------------------------------------------------------------------------
# The reduction extension (paper §V-B): consistency-region objects
# ---------------------------------------------------------------------------


def span_reduce(value, dp_axes: Sequence[str], op: str = "sum", *, mesh):
    """Fine-grained (object-granularity) reduction of a small shared
    object over the ranks of ``dp_axes``: one all-reduce; ``mean`` is the
    sum divided by the group's size, as ``lax.pmean`` does it."""
    axes = tuple(dp_axes)
    value = torch.as_tensor(value)
    if op == "sum":
        return _all_reduce(value, axes, "sum", mesh)
    if op == "mean":
        return _all_reduce(value, axes, "sum", mesh) / mesh.size(axes)
    if op == "max":
        return _all_reduce(value, axes, "max", mesh)
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Bucketing (page-granularity analogue)
# ---------------------------------------------------------------------------


def _flatten_to_buckets(tree, bucket_bytes: int):
    """(float32 buckets of the leaves in leaf order, each closed once it
    holds ``bucket_bytes`` or more; (shape, dtype) a leaf; the tree as
    the template to rebuild)."""
    leaves = [leaf for _, leaf in tree_flatten(tree)]
    buckets: List[torch.Tensor] = []
    cur: List[torch.Tensor] = []
    cur_b = 0
    for leaf in leaves:
        f = leaf.reshape(-1).to(torch.float32)
        cur.append(f)
        cur_b += f.numel() * 4
        if cur_b >= bucket_bytes:
            buckets.append(torch.cat(cur))
            cur, cur_b = [], 0
    if cur:
        buckets.append(torch.cat(cur))
    shapes = [(tuple(leaf.shape), leaf.dtype) for leaf in leaves]
    return buckets, shapes, tree


def _unflatten_buckets(buckets, shapes, template):
    flat = torch.cat([b.reshape(-1) for b in buckets])
    leaves, off = [], 0
    for shape, dtype in shapes:
        n = math.prod(shape)
        leaves.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return tree_unflatten(template, leaves)


# ---------------------------------------------------------------------------
# int8 ring all-reduce (compressed fine-grained diffs; beyond-paper)
# ---------------------------------------------------------------------------


# XLA compiles the reference's ``max / 127.0`` as a multiplication by the
# float32 reciprocal of 127 (its algebraic simplifier folds a division by
# a constant); the ring follows the compiled reference, which its train
# step runs, not the reference's op-by-op ``_quant``, which divides
_INV127 = 1.0 / 127.0


def _quant(x):
    """(int8 codes, float32 scale) as the reference's compiled ``_quant``:
    scale = max|x| * float32(1 / 127) + 1e-30, codes = x / scale (IEEE
    division) rounded half to even and clipped to +-127."""
    scale = torch.max(torch.abs(x)) * torch.tensor(
        _INV127, dtype=torch.float32, device=x.device) + 1e-30
    return (torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8),
            scale)


def _dequant(q, scale):
    return q.to(torch.float32) * scale


def _add_dequant(a, q, scale):
    """``a + q * scale`` rounded once to float32: the fused multiply-add
    into which XLA on the CPU contracts the reference's reduce-scatter
    add.  q * scale is exact in float64 (8 by 24 bits); the sum is
    rounded to float64, then to float32, and where that double rounding
    lands on a float32 midpoint that the exact sum (TwoSum's error term)
    lies beyond, the neighbour past the midpoint is taken."""
    a64, b64 = a.double(), q.double() * scale.double()
    t = a64 + b64
    bb = t - a64
    err = (a64 - (t - bb)) + (b64 - bb)         # a64 + b64 == t + err
    r = t.float()
    d = t - r.double()                          # exact
    nb = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf)
                         .to(torch.float32))
    past = (d != 0) & (2 * d == nb.double() - r.double()) & (err * d > 0)
    return torch.where(past, nb, r)


def ring_allreduce_int8(flat, axis: str, world: int, *, mesh):
    """Ring all-reduce over ``axis`` with per-hop int8 re-quantization:
    a reduce-scatter of ``world - 1`` hops, then each owner quantizes its
    reduced chunk once and that payload circulates verbatim for
    ``world - 1`` hops more, so every rank dequantizes the same (codes,
    scale) pairs and all end bit-equal.  Each hop is a cyclic permute
    (to the next rank on the axis, from the previous) of the codes and
    one of the scale."""
    if world == 1:
        return flat
    group, ranks = mesh.group((axis,))
    if len(ranks) != world:
        raise ValueError(f"axis {axis!r} has {len(ranks)} ranks, not {world}")
    n = flat.numel()
    x = torch.zeros(world, -(-n // world), dtype=flat.dtype,
                    device=flat.device)
    x.view(-1)[:n] = flat.reshape(-1)       # zero-padded copy: flat kept
    idx = mesh.axis_index(axis)
    dst, src = ranks[(idx + 1) % world], ranks[(idx - 1) % world]

    def hop(q, s):
        return (_permute(q, group, dst, src),
                _permute(s.reshape(1), group, dst, src).reshape(()))

    # reduce-scatter: after world - 1 hops chunk (idx + 1) % world is whole
    for k in range(world - 1):
        q, s = hop(*_quant(x[(idx - k) % world]))
        recv_ix = (idx - k - 1) % world
        x[recv_ix] = _add_dequant(x[recv_ix], q, s)
    # all-gather of each owner's one quantized chunk
    own_ix = (idx + 1) % world
    q, s = _quant(x[own_ix])
    x[own_ix] = _dequant(q, s)
    for k in range(world - 1):
        q, s = hop(q, s)
        x[(idx - k) % world] = _dequant(q, s)
    return x.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Barrier sync of ordinary-region state (bulk gradients)
# ---------------------------------------------------------------------------


def barrier_sync_grads(grads, dp_axes: Sequence[str], policy: RegCSyncPolicy,
                       *, axis_sizes: Optional[dict] = None,
                       mean: bool = True, mesh):
    """RegC rule 3 at the step barrier: make every ordinary store (a
    gradient contribution) performed with respect to all participants.

    ``axis_sizes`` ({axis: size}) is required for 'int8_ring', whose ring
    runs over the last dp axis after an all-reduce over the others; with
    ``mean`` and no ``axis_sizes`` the divisor is an all-reduce of 1, as
    the reference's ``psum`` of ones."""
    timed = SYNC_WALLS is not None
    if timed:
        dev = next(leaf for _, leaf in tree_flatten(grads)).device
        _device_sync(dev)
        t0 = time.perf_counter()
    out = _barrier_sync(grads, tuple(dp_axes), policy, axis_sizes, mean,
                        mesh)
    if timed:
        _device_sync(dev)
        SYNC_WALLS.append(time.perf_counter() - t0)
    return out


def _device_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier_sync(grads, axes, policy, axis_sizes, mean, mesh):
    def reduce_flat(flat):
        if policy.compression == "int8_ring":
            assert axis_sizes is not None, "int8_ring needs static axis sizes"
            out = flat
            # ring over the *last* dp axis; the preceding axes all-reduce
            if len(axes) > 1:
                out = _all_reduce(out, axes[:-1], "sum", mesh)
            return ring_allreduce_int8(out, axes[-1], axis_sizes[axes[-1]],
                                       mesh=mesh)
        return _all_reduce(flat, axes, "sum", mesh)

    if policy.granularity == "object":
        synced = tree_map(lambda g: reduce_flat(
            g.to(torch.float32).reshape(-1)).reshape(g.shape), grads)
    else:
        buckets, shapes, template = _flatten_to_buckets(grads,
                                                        policy.bucket_bytes)
        synced = _unflatten_buckets([reduce_flat(b) for b in buckets],
                                    shapes, template)
    if mean:
        if axis_sizes is not None:
            denom = 1.0
            for ax in axes:
                denom *= float(axis_sizes[ax])
        else:
            dev = next(leaf for _, leaf in tree_flatten(grads)).device
            denom = _all_reduce(torch.ones((), device=dev), axes, "sum",
                                mesh)
        synced = tree_map(lambda g: g / denom, synced)
    return synced
