"""The train step (the port of the reference's ``train/train_step.py``).

``make_train_step`` is the reference's GSPMD path at one process (no
sharding context: its batch and parameter constraints are the
identity): the loss and its gradients (``torch.autograd.grad`` over the
parameter tree), optionally over ``n_micro`` microbatches whose
gradients are summed in order from zeros and scaled by 1 / n_micro, then
the optimiser update (``adamw`` or ``adamw8bit``) at the schedule's
rate.

``make_train_step_regc`` is the explicit RegC path over the ranks of a
``torch.distributed`` world (the reference's ``shard_map`` manual over
the dp axes): parameters and optimiser state replicated on every rank,
each rank taking its block of the global batch's rows, gradients
accumulated locally over microbatches and synced at the step barrier by
``barrier_sync_grads`` under ``hp.sync`` (lazy: once a step; eager:
every microbatch), the loss through ``span_reduce``, the global grad
norm from the synced gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, clip_by_global_norm, init_opt_state,
    warmup_cosine,
)
from repro_torch.regc_sync.policies import (
    RegCSyncPolicy, barrier_sync_grads, span_reduce,
)
from repro_torch.utils.tree import (
    global_sq_norm, tree_add, tree_leaves, tree_scale, tree_unflatten,
    tree_zeros_like,
)

SHARDING_PENDING = ("sharding rules (tensor and expert parallelism) wait "
                    "for ROADMAP item 13e")


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


def make_train_step(cfg: ModelConfig, hp: TrainHParams, ctx=None):
    """``train_step(params, opt_state, batch, step, *, with_grads=False)
    -> (new_params, new_opt_state, metrics[, grads])``: metrics ``loss``,
    ``grad_norm``, ``lr`` and the loss's scalar metrics (``ce``,
    ``aux_loss``; ``ce`` alone over microbatches), 0-d tensors on the
    parameters' device; ``grads`` the gradients before clipping.  ``ctx`` must
    be None (one process), and ``hp.sync`` the default policy: one
    process syncs nothing, so any other policy would be ignored (the
    policy applies on ``make_train_step_regc``)."""
    if ctx is not None:
        raise NotImplementedError(f"a sharding context: {SHARDING_PENDING}")
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

    def loss_f(params, batch):
        return M.loss_fn(cfg, params, batch, attn_impl=hp.attn_impl,
                         remat=hp.remat, ce_chunk=hp.ce_chunk,
                         remat_segment=hp.remat_segment)

    def train_step(params, opt_state, batch, step, *, with_grads=False):
        if hp.n_micro == 1:
            (loss, metrics), grads = value_and_grad(loss_f, params, batch)
        else:
            bdim = lambda k: 1 if (k == "positions" and cfg.mrope) else 0  # noqa: E731
            mbatch = _microbatch(batch, hp.n_micro, bdim)
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
    ``adamw_update`` whatever ``hp.opt_impl`` says."""
    if inner_ctx is not None:
        raise NotImplementedError(f"inner_ctx: {SHARDING_PENDING}")
    sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    dp_axes = tuple(dp_axes)
    axis_sizes = {a: mesh.shape[a] for a in dp_axes}
    dp_world = mesh.size(dp_axes)
    block = mesh.block_index(dp_axes)
    bdim = lambda k: 1 if (k == "positions" and cfg.mrope) else 0  # noqa: E731

    def loss_f(params, batch):
        return M.loss_fn(cfg, params, batch, attn_impl=hp.attn_impl,
                         remat=hp.remat, ce_chunk=hp.ce_chunk,
                         remat_segment=hp.remat_segment)

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
            sq = global_sq_norm(grads)      # synced: equal on every rank
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
