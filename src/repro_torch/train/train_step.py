"""The train step (the port of the reference's ``train/train_step.py``).

``make_train_step`` is the reference's GSPMD path at one process (no
sharding context: its batch and parameter constraints are the
identity): the loss and its gradients (``torch.autograd.grad`` over the
parameter tree), optionally over ``n_micro`` microbatches whose
gradients are summed in order from zeros and scaled by 1 / n_micro, then
the optimiser update (``adamw`` or ``adamw8bit``) at the schedule's
rate.

With a sharding context (``models.sharding.ShardingCtx`` over a
``launch.mesh.Mesh``; every rules table, either ``gather_fsdp``) it is
the reference's GSPMD step made explicit on every rank of the mesh: each
rank passes the same global batch and keeps its block of every
(micro)batch's rows over the rule's batch axes (all of them where
``batch`` is None; M-RoPE positions split on dim 1; ``embeds`` cut to
the activations' d_model block under the 2-D tables), holds its blocks
of the parameters and optimiser state (``shard_state``: AdamW's moments,
or the int8 state laid out as the reference's ``opt_specs``), runs the
loss with the collectives of tensor, expert, FSDP and sequence
parallelism (``RankLayout.for_batch``), then sums each gradient leaf
over the batch axes it is not split on (an FSDP dim's sum is the
gather's backward: not summed twice), takes the global grad norm (each
leaf's square norm summed over exactly the axes it is split on), clips
and updates its blocks with AdamW or ``adamw8bit`` (whose codes and
scales are the whole leaf's, ``optim.quantized``).  Leaves held alike
on several ranks stay bit-equal.

``make_train_step_regc`` is the explicit RegC path over the ranks of a
``torch.distributed`` world (the reference's ``shard_map`` manual over
the dp axes): parameters and optimiser state replicated on every rank,
each rank taking its block of the global batch's rows, gradients
accumulated locally over microbatches and synced at the step barrier by
``barrier_sync_grads`` under ``hp.sync`` (lazy: once a step; eager:
every microbatch), the loss through ``span_reduce``, the global grad
norm from the synced gradients.  An ``inner_ctx`` whose rules name no
dp axis shards the model over the mesh's other axes inside it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.models import collectives as C
from repro_torch.models import model as M
from repro_torch.models.sharding import (
    RankLayout, ShardingCtx, check_ctx, constrain, entry_axes,
    gather_params, opt_shardings, param_shardings, q8_specs, shard_params,
    spec_leaves,
)
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, clip_by_global_norm, init_opt_state,
    warmup_cosine,
)
from repro_torch.regc_sync.policies import (
    RegCSyncPolicy, barrier_sync_grads, span_reduce,
)
from repro_torch.utils.tree import (
    global_sq_norm, tree_add, tree_leaves, tree_map, tree_scale,
    tree_unflatten, tree_zeros_like,
)


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    adamw: AdamWConfig = AdamWConfig()
    n_micro: int = 1
    remat: Optional[str] = "dots"
    remat_segment: int = 0       # >1: sqrt-N segmented remat (see run_stack)
    attn_impl: str = "blocked"
    ce_chunk: int = 1024
    opt_impl: str = "adamw"      # 'adamw' | 'adamw8bit' (blockwise-int8 m,v)
    sync: RegCSyncPolicy = RegCSyncPolicy()


def _microbatch(batch, n_micro, batch_dim_of):
    """Split each leaf's batch dim into (n_micro, b / n_micro), the
    microbatch index first."""
    def resh(k, a):
        bd = batch_dim_of(k)
        b = a.shape[bd]
        assert b % n_micro == 0, (k, b, n_micro)
        new = a.shape[:bd] + (n_micro, b // n_micro) + a.shape[bd + 1:]
        return torch.movedim(a.reshape(new), bd, 0)
    return {k: resh(k, v) for k, v in batch.items()}


def value_and_grad(loss_f, params, batch):
    """((loss, metrics), grads): the gradient of every parameter leaf,
    zeros for a leaf the loss does not read (as JAX gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_f(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def _bdim(cfg):
    return lambda k: 1 if (k == "positions" and cfg.mrope) else 0  # noqa: E731


def _loss_f(cfg, hp, layout=None, moe_groups=1, moe_group_aux=False):
    def loss_f(params, batch):
        return M.loss_fn(cfg, params, batch, attn_impl=hp.attn_impl,
                         remat=hp.remat, ce_chunk=hp.ce_chunk,
                         remat_segment=hp.remat_segment, layout=layout,
                         moe_groups=moe_groups, moe_group_aux=moe_group_aux)
    return loss_f


def batch_logical_axes(cfg: ModelConfig, key: str, ndim: int):
    if key == "positions" and cfg.mrope:
        return (None, "batch", "seq")
    if key == "embeds":
        return ("batch", "seq", "embed")
    return ("batch", "seq")[:ndim]


def local_rows(cfg, batch, layout):
    """This rank's block of every leaf's rows under ``layout`` (the
    reference's ``_constrain_batch``), and of the ``embeds``' d_model
    where the activations split it."""
    bdim = _bdim(cfg)

    def block(k, v):
        v = layout.rows(v, bdim(k))
        if k == "embeds" and layout.embed_axes:
            v = C.own_block(v, -1, layout.embed_axes, layout.mesh)
        return v
    return {k: constrain(block(k, v), v.shape,
                         batch_logical_axes(cfg, k, v.dim()), layout.ctx)
            for k, v in batch.items()}


def batch_layout(cfg, ctx: ShardingCtx, batch, n_micro: int = 1
                 ) -> RankLayout:
    """The layout of one microbatch of the global ``batch``."""
    b, s_len = batch["targets"].shape
    if b % n_micro:
        raise ValueError(f"batch of {b} rows in {n_micro} microbatches")
    return RankLayout.for_batch(ctx, b // n_micro, cfg, s_len)


def make_train_step(cfg: ModelConfig, hp: TrainHParams,
                    ctx: Optional[ShardingCtx] = None, *, moe_groups=1,
                    moe_group_aux=False):
    """``train_step(params, opt_state, batch, step, *, with_grads=False)
    -> (new_params, new_opt_state, metrics[, grads])``: metrics ``loss``,
    ``grad_norm``, ``lr`` and the loss's scalar metrics (``ce``,
    ``aux_loss``; ``ce`` alone over microbatches), 0-d tensors on the
    parameters' device; ``grads`` the gradients before clipping.
    ``hp.sync`` must be the default policy: the GSPMD step syncs nothing
    of its own, so any other policy would be ignored (the policy applies
    on ``make_train_step_regc``).

    With ``ctx`` every rank of ``ctx.mesh`` calls the step with the same
    global batch and its own blocks of the state (see the module's note;
    ``grads`` are this rank's blocks).  Without it, one process;
    ``moe_groups`` / ``moe_group_aux`` then set its MoE dispatch groups
    (``layers.moe_block``), so that it computes what a sharded step
    computes."""
    if hp.sync != RegCSyncPolicy():
        raise NotImplementedError(
            f"sync={hp.sync} applies on the explicit RegC path "
            "(make_train_step_regc, Trainer path='regc', launch.train "
            "--path regc); this one-process step syncs nothing")
    sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    if hp.opt_impl == "adamw8bit":
        from repro_torch.optim.quantized import adamw8bit_update as opt_update
    elif hp.opt_impl == "adamw":
        opt_update = adamw_update
    else:
        raise ValueError(f"opt_impl={hp.opt_impl!r}; allowed: 'adamw', "
                         "'adamw8bit'")

    if ctx is not None:
        check_ctx(cfg, ctx)
        return _sharded_step(cfg, hp, ctx, sched)
    loss_f = _loss_f(cfg, hp, moe_groups=moe_groups,
                     moe_group_aux=moe_group_aux)

    def train_step(params, opt_state, batch, step, *, with_grads=False):
        if hp.n_micro == 1:
            (loss, metrics), grads = value_and_grad(loss_f, params, batch)
        else:
            mbatch = _microbatch(batch, hp.n_micro, _bdim(cfg))
            grads = tree_zeros_like(params, torch.float32)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(hp.n_micro):
                (l, _), g = value_and_grad(
                    loss_f, params, {k: v[i] for k, v in mbatch.items()})
                grads = tree_add(grads, g)
                loss = loss + l
            grads = tree_scale(grads, 1.0 / hp.n_micro)
            loss = loss / hp.n_micro
            metrics = {"ce": loss}
        dev = loss.device
        lr = sched(step, dev)
        with torch.no_grad():
            new_params, new_opt, gnorm = opt_update(
                params, grads, opt_state, step, lr, hp.adamw)
        out_metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out_metrics.update({k: v for k, v in metrics.items()
                            if v.dim() == 0})
        if with_grads:
            return new_params, new_opt, out_metrics, grads
        return new_params, new_opt, out_metrics

    return train_step


def leaf_specs(cfg, ctx: ShardingCtx) -> list:
    """The spec of every parameter leaf, in leaf order."""
    return spec_leaves(param_shardings(M.param_specs(cfg), ctx))


def _split_axes(spec) -> frozenset:
    return frozenset(a for e in spec for a in entry_axes(e))


def _by_axes(specs, axes_of):
    """Leaf indices grouped by ``axes_of(spec)``, groups in order of
    their first leaf."""
    groups: dict = {}
    for i, spec in enumerate(specs):
        groups.setdefault(axes_of(spec), []).append(i)
    return groups


def sync_sharded_grads(grads, specs, layout: RankLayout):
    """Each gradient leaf summed over the batch axes it is not split on,
    one all-reduce of the leaves' concatenation a set of axes."""
    leaves = tree_leaves(grads)
    mesh = layout.mesh

    def axes_of(spec):
        split = _split_axes(spec)
        return tuple(a for a in layout.batch_axes if a not in split)
    out = list(leaves)
    for axes, idx in _by_axes(specs, axes_of).items():
        if not axes or mesh.size(axes) == 1:
            continue
        flat = C.reduce(torch.cat([leaves[i].reshape(-1) for i in idx]),
                        axes, mesh)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(leaves[i].shape)
            off += n
    return tree_unflatten(grads, out)


def sharded_sq_norm(grads, specs, mesh):
    """The global square norm of sharded gradients: each leaf's local
    square norm (float32) summed over exactly the axes it is split on,
    so a block held alike on several ranks counts once.  Leaves are
    summed in leaf order within a set of axes (of more than one rank),
    the sets in the order of their first leaf."""
    leaves = tree_leaves(grads)
    total = None
    groups = _by_axes(specs, lambda sp: tuple(
        a for a in mesh.axes if a in _split_axes(sp) and mesh.shape[a] > 1))
    for axes, idx in groups.items():
        part = sum(torch.sum(torch.square(leaves[i].float())) for i in idx)
        part = C.reduce(part, axes, mesh) if axes else part
        total = part if total is None else total + part
    return total


def _opt_impl_of(opt_state) -> str:
    """'adamw' for a state ``{"m", "v"}``, 'adamw8bit' for the int8
    tree (the parameters' structure, a dict of codes and scales a
    leaf)."""
    return "adamw" if set(opt_state) == {"m", "v"} else "adamw8bit"


def shard_state(cfg, ctx: ShardingCtx, params, opt_state=None):
    """This rank's blocks of full ``params`` (and of an AdamW state
    ``{"m", "v"}`` or an int8 state, laid out by ``opt_shardings``)."""
    spec_tree = M.param_specs(cfg)
    local = shard_params(params, ctx, param_shardings(spec_tree, ctx))
    if opt_state is None:
        return local
    return local, shard_params(opt_state, ctx, opt_shardings(
        spec_tree, ctx, _opt_impl_of(opt_state)))


def gather_state(cfg, ctx: ShardingCtx, params, opt_state=None):
    """The full trees back from every rank's blocks (collective)."""
    spec_tree = M.param_specs(cfg)
    full = gather_params(params, ctx, param_shardings(spec_tree, ctx))
    if opt_state is None:
        return full
    return full, gather_params(opt_state, ctx, opt_shardings(
        spec_tree, ctx, _opt_impl_of(opt_state)))


def q8_shards(cfg, ctx: ShardingCtx):
    """Per parameter leaf, the axes (of more than one rank) its last dim
    and its int8 scales' last dim are split over: ``adamw8bit_update``'s
    ``shards``."""
    def last(spec):
        return tuple(a for a in entry_axes(spec[-1])
                     if ctx.mesh.shape[a] > 1) if spec else ()
    return [tuple(last(sp) for sp in q8_specs(s, ctx))
            for s in spec_leaves(M.param_specs(cfg))]


def apply_sharded_update(params, grads, opt_state, step, lr, hp, specs, mesh,
                         q8=None):
    """(new params, new opt state, grad norm): the global norm of the
    synced sharded ``grads``, the clip, and the update on this rank's
    blocks: AdamW, or with ``hp.opt_impl == "adamw8bit"`` the int8 update
    (``q8``: ``q8_shards`` of the ctx)."""
    sq = sharded_sq_norm(grads, specs, mesh)
    if hp.opt_impl == "adamw8bit":
        from repro_torch.optim.quantized import adamw8bit_update
        return adamw8bit_update(params, grads, opt_state, step, lr,
                                hp.adamw, sq_norm=sq, shards=(q8, mesh))
    if hp.adamw.clip_norm is not None:
        clipped, gnorm = clip_by_global_norm(
            tree_map(lambda g: g.float(), grads), hp.adamw.clip_norm,
            sq_norm=sq)
    else:
        clipped, gnorm = grads, torch.sqrt(sq)
    new_params, new_opt, _ = adamw_update(
        params, clipped, opt_state, step, lr,
        dataclasses.replace(hp.adamw, clip_norm=None))
    return new_params, new_opt, gnorm


def _sharded_step(cfg, hp, ctx, sched):
    specs = leaf_specs(cfg, ctx)
    q8 = q8_shards(cfg, ctx) if hp.opt_impl == "adamw8bit" else None
    bdim = _bdim(cfg)

    def train_step(params, opt_state, batch, step, *, with_grads=False):
        layout = batch_layout(cfg, ctx, batch, hp.n_micro)
        loss_f = _loss_f(cfg, hp, layout)
        if hp.n_micro == 1:
            (loss, metrics), grads = value_and_grad(
                loss_f, params, local_rows(cfg, batch, layout))
        else:
            mbatch = _microbatch(batch, hp.n_micro, bdim)
            grads = tree_zeros_like(params, torch.float32)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(hp.n_micro):
                (l, _), g = value_and_grad(loss_f, params, local_rows(
                    cfg, {k: v[i] for k, v in mbatch.items()}, layout))
                grads = tree_add(grads, g)
                loss = loss + l
            grads = tree_scale(grads, 1.0 / hp.n_micro)
            loss = loss / hp.n_micro
            metrics = {"ce": loss}
        grads = sync_sharded_grads(grads, specs, layout)
        lr = sched(step, loss.device)
        with torch.no_grad():
            new_params, new_opt, gnorm = apply_sharded_update(
                params, grads, opt_state, step, lr, hp, specs, ctx.mesh, q8)
        out_metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out_metrics.update({k: v for k, v in metrics.items()
                            if v.dim() == 0})
        if with_grads:
            return new_params, new_opt, out_metrics, grads
        return new_params, new_opt, out_metrics

    return train_step


def eval_loss(cfg: ModelConfig, hp: TrainHParams, params, batch,
              ctx: Optional[ShardingCtx] = None, *, moe_groups=1,
              moe_group_aux=False):
    """(loss, metrics) of the whole ``batch`` without gradients, every
    metric (``expert_load`` too); with ``ctx`` on this rank's blocks, as
    the step computes them (one microbatch)."""
    layout = None
    if ctx is not None:
        check_ctx(cfg, ctx)
        layout = batch_layout(cfg, ctx, batch)
        batch = local_rows(cfg, batch, layout)
    with torch.no_grad():
        return _loss_f(cfg, hp, layout, moe_groups, moe_group_aux)(
            params, batch)


def _check_inner_ctx(cfg, inner_ctx, dp_axes):
    """The reference's refusals of an ``inner_ctx``: a rule on a dp axis
    (a manual axis of its ``shard_map``) and the nested ``shard_map`` of
    ``moe_impl='ep'``."""
    if inner_ctx.moe_impl == "ep":
        raise ValueError(
            "moe_impl='ep' inside the RegC path nests a shard_map: the "
            "context mesh should match the mesh passed to shard_map")
    on_dp = sorted(str(k) for k, v in inner_ctx.rules.items()
                   if v and any(a in dp_axes for a in v))
    if on_dp:
        raise ValueError(f"the inner context's rules {on_dp} name the "
                         f"manual axes {tuple(dp_axes)} of the RegC path")
    check_ctx(cfg, inner_ctx)


def make_train_step_regc(cfg: ModelConfig, hp: TrainHParams, mesh,
                         dp_axes=("data",), inner_ctx=None):
    """``step_fn(params, opt_state, batch, step, *, with_grads=False) ->
    (new_params, new_opt_state, metrics[, synced grads])`` on every rank
    of ``mesh`` (a ``launch.mesh.Mesh``), each passing the same global
    ``batch`` and the same replicated state: the rank keeps its
    contiguous block of the batch rows, in rank order over ``dp_axes``
    (M-RoPE positions split on dim 1).  Metrics ``loss`` (the ranks'
    mean), ``grad_norm`` (of the synced gradients, before clipping) and
    ``lr``, equal on every rank.  As the reference, the update is
    ``adamw_update`` whatever ``hp.opt_impl`` says.

    ``inner_ctx`` (on ``mesh``; rules naming no dp axis, ``moe_impl``
    'dense'; else a ``ValueError``, as the reference) splits the model
    over the mesh's other axes: ``params`` and ``opt_state`` are then
    this rank's blocks (``shard_state``), the sync runs over ``dp_axes``
    on them and the grad norm sums each leaf over the axes it is split
    on."""
    dp_axes = tuple(dp_axes)
    specs = None
    if inner_ctx is not None:
        _check_inner_ctx(cfg, inner_ctx, dp_axes)
        specs = leaf_specs(cfg, inner_ctx)
    sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    axis_sizes = {a: mesh.shape[a] for a in dp_axes}
    dp_world = mesh.size(dp_axes)
    block = mesh.block_index(dp_axes)
    bdim = _bdim(cfg)

    def sync(grads):
        return barrier_sync_grads(grads, dp_axes, hp.sync,
                                  axis_sizes=axis_sizes, mesh=mesh)

    def local_rows(k, a):
        b = a.shape[bdim(k)]
        if b % dp_world:
            raise ValueError(f"batch {k!r} has {b} rows, not a multiple "
                             f"of the {dp_world} data-parallel ranks")
        n = b // dp_world
        return a.narrow(bdim(k), block * n, n)

    eager = hp.sync.ordinary_sync == "eager"

    def step_fn(params, opt_state, batch, step, *, with_grads=False):
        batch = {k: local_rows(k, v) for k, v in batch.items()}
        if inner_ctx is not None:
            loss_f = _loss_f(cfg, hp, batch_layout(cfg, inner_ctx, batch,
                                                   hp.n_micro))
        else:
            loss_f = _loss_f(cfg, hp)
        if hp.n_micro == 1:
            (loss, _), grads = value_and_grad(loss_f, params, batch)
            if eager:
                grads = sync(grads)
        else:
            mbatch = _microbatch(batch, hp.n_micro, bdim)
            grads = tree_zeros_like(params, torch.float32)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(hp.n_micro):
                (l, _), g = value_and_grad(
                    loss_f, params, {k: v[i] for k, v in mbatch.items()})
                if eager:
                    # RC-like: propagate ordinary stores at every release
                    g = sync(g)
                grads = tree_add(grads, g)
                loss = loss + l
            grads = tree_scale(grads, 1.0 / hp.n_micro)
            loss = loss / hp.n_micro
        if not eager:
            # RegC: ordinary stores propagated once, at the step barrier
            grads = sync(grads)
        # consistency-region object: the reduction extension
        loss = span_reduce(loss, dp_axes, "mean", mesh=mesh)
        with torch.no_grad():
            # synced: equal on every rank of the dp axes
            sq = (global_sq_norm(grads) if specs is None
                  else sharded_sq_norm(grads, specs, mesh))
            if hp.adamw.clip_norm is not None:
                clipped, gnorm = clip_by_global_norm(
                    grads, hp.adamw.clip_norm, sq_norm=sq)
            else:
                clipped, gnorm = grads, torch.sqrt(sq)
            lr = sched(step, loss.device)
            new_params, new_opt, _ = adamw_update(
                params, clipped, opt_state, step, lr,
                dataclasses.replace(hp.adamw, clip_norm=None))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if with_grads:
            return new_params, new_opt, metrics, grads
        return new_params, new_opt, metrics

    return step_fn


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     dtype=torch.float32, *, device="cuda"):
    """(params, opt_state): seeded parameters (``init_model_params``) and
    zero AdamW moments on ``device`` (the card unless the CPU is asked
    for; raises without a card)."""
    resolve_device(device)
    params = M.init_model_params(cfg, generator, dtype, device=device)
    return params, init_opt_state(params)
