"""The collectives of tensor, expert and FSDP parallelism, differentiable
(the reference has none to port: GSPMD inserts them from its layout
constraints, and ``moe_block_ep`` has one ``lax.psum``).

* ``all_reduce(x, axes, mesh)``: forward the sum over the ranks of
  ``axes``, backward the identity (Megatron's g: the sum of partial
  products, whose result every rank then uses as its own);
* ``copy_to(x, axes, mesh)``: forward the identity, backward the sum of
  the gradients over ``axes`` (Megatron's f: a value the ranks hold
  alike entering work that differs between them);
* ``all_gather(x, dim, axes, mesh, sum_axes)``: forward the blocks of
  ``dim`` gathered over ``axes`` (row-major over them, in that order, as
  ``Mesh.block_index`` numbers the blocks), backward this rank's block
  of the gradient summed over ``sum_axes`` (the FSDP gather's
  reduce-scatter: the data ranks' shares of a weight's gradient summed
  exactly once);
* ``shared_sum(x, axes, mesh)``: the sum over ``axes`` in both
  directions, forward and backward (a sum of squares that each rank
  then applies to its own block of the activations: ``all_reduce``
  then ``copy_to``);
* ``seq_block(x, dim, axes, mesh)``: forward this rank's block of
  ``dim`` over ``axes`` (a copy of its own), backward the gradient's
  blocks all-gathered (the sequence-parallel boundary of a saved
  residual; the next super-block gathers it with ``all_gather`` and
  empty ``sum_axes``, whose backward takes the own block);
* ``all_reduce_max(x, axes, mesh)``: the max, no gradient (the
  distributed logsumexp's shift, the int8 state's absmax of a block
  that spans ranks);
* ``gather_full(t, spec, mesh)``: every sharded dim of ``t`` gathered,
  no gradient (checkpoints and checks);
* ``reduce(x, axes, mesh, op)`` and ``gather(x, dim, axes, mesh)``: the
  sum or max, and the all-gather, without autograd (serving: the
  vocab-parallel logits' gather, the q heads' gather before a
  context-parallel decode, the softmax combine's max and sums).

Each runs in the process group of the ``launch.mesh.Mesh`` axes and is
skipped when the group holds one rank.  The ranks run gloo, which takes
only host tensors, so a card's operand is staged to the host and back,
explicitly, as ``regc_sync.policies`` stages it.  Each call counts, by
(kind, axes), the bytes of this rank's operand and one message in
``COLLECTIVE_BYTES`` / ``COLLECTIVE_MSGS``, and the bytes copied either
way and the messages staged in ``STAGED``; ``reset_collectives`` zeroes
them.  A parameter's gather (``all_gather(..., param=True)``, the FSDP
gather of ``RankLayout.gather_leaf``) also counts its bytes and one
message in ``PARAM_GATHERS``: zero under the no-regather decode tables.
Where the gathered axes do not all split the batch (an FSDP dim
on an axis the batch is not split over, where the ranks' gradients are
alike), the backward sums over the others only and takes this rank's
block.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter")
COLLECTIVE_BYTES: Dict[Tuple[str, Tuple[str, ...]], int] = {}
COLLECTIVE_MSGS: Dict[Tuple[str, Tuple[str, ...]], int] = {}
STAGED = {"bytes": 0, "messages": 0}
PARAM_GATHERS = {"bytes": 0, "messages": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_collectives():
    COLLECTIVE_BYTES.clear()
    COLLECTIVE_MSGS.clear()
    STAGED.update(bytes=0, messages=0)
    PARAM_GATHERS.update(bytes=0, messages=0)


def _count(kind: str, axes: Tuple[str, ...], t: torch.Tensor):
    key = (kind, tuple(axes))
    COLLECTIVE_BYTES[key] = (COLLECTIVE_BYTES.get(key, 0)
                             + t.numel() * t.element_size())
    COLLECTIVE_MSGS[key] = COLLECTIVE_MSGS.get(key, 0) + 1


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous host copy of ``t`` that a gloo collective may write
    (``t`` kept); a card's tensor is counted as staged."""
    if dist.get_backend(group) != "gloo":
        raise RuntimeError(f"the ranks run {dist.get_backend(group)}; the "
                           "collectives are written for gloo")
    if t.is_cuda:
        STAGED["bytes"] += 2 * t.numel() * t.element_size()
        STAGED["messages"] += 1
        return t.to("cpu", memory_format=torch.contiguous_format)
    return t.clone(memory_format=torch.contiguous_format)


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def reduce(x: torch.Tensor, axes, mesh, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over the ranks of ``axes`` (a new tensor;
    ``x`` itself where the group holds one rank)."""
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    group, _ = mesh.group(axes)
    _count("all-reduce", axes, x)
    out = _host(x, group)
    dist.all_reduce(out, _OPS[op], group=group)
    return out.to(x.device)


def gather(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The blocks of ``dim`` from every rank of ``axes``, in block order
    over ``axes`` as given."""
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    group, ranks = mesh.group(axes)
    _count("all-gather", axes, x)
    send = _host(x, group)
    parts = [torch.empty_like(send) for _ in ranks]
    dist.all_gather(parts, send, group=group)
    order = sorted(range(len(ranks)),
                   key=lambda i: mesh.block_index(axes, ranks[i]))
    return torch.cat([parts[i] for i in order], dim=dim).to(x.device)


def reduce_scatter(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, this rank's block of
    ``dim`` of it (block order over ``axes`` as given)."""
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    group, ranks = mesh.group(axes)
    _count("reduce-scatter", axes, x)
    n = x.shape[dim] // len(ranks)
    host = _host(x, group)
    parts = [host.narrow(dim, mesh.block_index(axes, r) * n, n).contiguous()
             for r in ranks]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.device)


def own_block(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    axes = _axes(axes)
    if not axes:
        return x
    n = x.shape[dim] // mesh.size(axes)
    return x.narrow(dim, mesh.block_index(axes) * n, n)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce(g, ctx.axes, ctx.mesh), None, None


class _SeqBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return own_block(x, dim, axes, mesh).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.dim, ctx.axes, ctx.mesh), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh, sum_axes):
        ctx.dim, ctx.axes, ctx.mesh, ctx.sum_axes = dim, axes, mesh, sum_axes
        return gather(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        if set(ctx.sum_axes) == set(ctx.axes):
            g = reduce_scatter(g, ctx.dim, ctx.axes, ctx.mesh)
        else:
            g = own_block(reduce(g, ctx.sum_axes, ctx.mesh),
                          ctx.dim, ctx.axes, ctx.mesh).contiguous()
        return g, None, None, None, None


def all_reduce(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    return _AllReduce.apply(x, axes, mesh)


def copy_to(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    return _CopyTo.apply(x, axes, mesh)


def shared_sum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return copy_to(all_reduce(x, axes, mesh), axes, mesh)


def seq_block(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    return _SeqBlock.apply(x, dim, axes, mesh)


def all_gather(x: torch.Tensor, dim: int, axes, mesh,
               sum_axes: Sequence[str] = (), param: bool = False
               ) -> torch.Tensor:
    axes = _axes(axes)
    if not axes or mesh.size(axes) == 1:
        return x
    if param:
        PARAM_GATHERS["bytes"] += x.numel() * x.element_size()
        PARAM_GATHERS["messages"] += 1
    return _AllGather.apply(x, dim, axes, mesh, tuple(sum_axes))


def all_reduce_max(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return reduce(x.detach(), axes, mesh, op="max")


def gather_full(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    from repro_torch.models.sharding import entry_axes
    for dim, entry in enumerate(spec):
        t = gather(t, dim, entry_axes(entry), mesh)
    return t
