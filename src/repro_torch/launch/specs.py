"""Dry-run targets: one rank's step and its arguments as ``meta`` tensors
at the rank's block shapes, for every (arch x shape x mesh) cell (the
port of the reference's ``launch/specs.py``).

The reference lowers a GSPMD program over every device of a mesh and
hands XLA abstract arrays and their shardings.  The port has no program
to lower: ``dry_target`` builds the step a rank of ``mesh`` (a
``launch.mesh.AbstractMesh``) runs and its arguments with no storage,
and ``launch.dryrun`` runs it under ``launch.op_analysis``.  The rules,
the batch's layout and the analytic ``model_flops`` are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.sharding import (
    DEFAULT_RULES, LONG_CONTEXT_RULES, SERVE_RULES, SMALL_MODEL_RULES,
    SMALL_SERVE_RULES, ShardingCtx, _spec_map, q8_specs,
)
from repro_torch.optim.quantized import scale_shape
from repro_torch.serve.decode import make_prefill_step, make_serve_step
from repro_torch.train.train_step import TrainHParams, make_train_step
from repro_torch.utils.tree import tree_bytes

# d_model at or below this: TP all-reduce (O(B*S*d) per layer) outweighs its
# O(d^2) flops share; spend the model axis on DP instead (see SMALL_*_RULES)
SMALL_D_MODEL = 3072

# the port's token ids, targets and M-RoPE positions: int32, as the data
# pipeline gives them
TOKEN_DTYPE = torch.int32


class Abstract(NamedTuple):
    """A tensor's shape and dtype, no storage (the reference's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.dtype.itemsize


def rules_for(cfg: ModelConfig, shape: ShapeConfig, rules_override=None):
    if rules_override is not None:
        return rules_override
    # MoE keeps DEFAULT even at small d_model: the expert dim is where the
    # parallelism lives; SMALL rules would replicate the expert weights.
    small = cfg.d_model <= SMALL_D_MODEL and cfg.moe is None
    if shape.kind == "train":
        return SMALL_MODEL_RULES if small else DEFAULT_RULES
    if shape.name == "long_500k":
        return LONG_CONTEXT_RULES
    return SMALL_SERVE_RULES if small else SERVE_RULES


def make_ctx(mesh, cfg: ModelConfig, shape: ShapeConfig,
             rules_override=None, **ctx_opts) -> ShardingCtx:
    return ShardingCtx(mesh=mesh, rules=rules_for(cfg, shape, rules_override),
                       **ctx_opts)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingCtx,
                *, dtype=torch.bfloat16):
    """({name: Abstract}, {name: spec}) of the global input batch:
    ``tokens`` (B, S) or ``embeds`` (B, S, d) in ``dtype``, ``targets``
    in training, (3, B, S) ``positions`` under M-RoPE; S is 1 at decode.
    Ids and positions are ``TOKEN_DTYPE``."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    specs, shards = {}, {}
    if cfg.input_mode == "embeds":
        specs["embeds"] = Abstract((B, S, cfg.d_model), dtype)
        shards["embeds"] = ctx.spec_for((B, S, cfg.d_model),
                                        ("batch", "seq", "embed"))
    else:
        specs["tokens"] = Abstract((B, S), TOKEN_DTYPE)
        shards["tokens"] = ctx.spec_for((B, S), ("batch", "seq"))
    if shape.kind == "train":
        specs["targets"] = Abstract((B, S), TOKEN_DTYPE)
        shards["targets"] = ctx.spec_for((B, S), ("batch", "seq"))
    if cfg.mrope:
        specs["positions"] = Abstract((3, B, S), TOKEN_DTYPE)
        shards["positions"] = ctx.spec_for((3, B, S),
                                           (None, "batch", "seq"))
    return specs, shards


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def param_blocks(cfg: ModelConfig, ctx: ShardingCtx, dtype):
    """This rank's blocks of every parameter, on ``meta``."""
    return _spec_map(lambda s: _meta(
        ctx.block_shape(s.shape, ctx.spec_for(s.shape, s.axes)), dtype),
        M.param_specs(cfg))


def opt_blocks(cfg: ModelConfig, ctx: ShardingCtx, opt_impl: str = "adamw"):
    """This rank's blocks of the optimiser state on ``meta``, laid out by
    ``sharding.opt_shardings``: AdamW's float32 moments, or the int8
    codes and float32 scales of ``adamw8bit``."""
    spec_tree = M.param_specs(cfg)
    if opt_impl == "adamw":
        return {k: param_blocks(cfg, ctx, torch.float32) for k in ("m", "v")}
    if opt_impl != "adamw8bit":
        raise ValueError(f"opt_impl={opt_impl!r}; allowed: 'adamw', "
                         "'adamw8bit'")

    def leaf(s):
        q, sc = q8_specs(s, ctx)
        qs = ctx.block_shape(s.shape, q)
        ss = ctx.block_shape(scale_shape(s.shape), sc)
        return {"m_q": _meta(qs, torch.int8), "m_s": _meta(ss, torch.float32),
                "v_q": _meta(qs, torch.int8), "v_s": _meta(ss, torch.float32)}
    return _spec_map(leaf, spec_tree)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D (+ attention
    cache reads) for inference steps."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        base = 6.0 * n_active * D
        attn = 0.0
        for spec in cfg.pattern:
            if spec.kind != "attn":
                continue
            ctx_len = min(cfg.window or shape.seq_len, shape.seq_len) \
                if spec.attn_type == "local" else shape.seq_len
            # fwd 2*2*B*S*ctx*Hq*D ; bwd ~2x
            attn += 3 * 2 * 2 * shape.global_batch * shape.seq_len * ctx_len \
                * cfg.n_heads * cfg.head_dim * 0.5 * cfg.n_superblocks
        return base + attn
    D = shape.global_batch  # one token per sequence
    base = 2.0 * n_active * D
    for spec in cfg.pattern:
        if spec.kind != "attn":
            continue
        ctx_len = min(cfg.window or shape.seq_len, shape.seq_len) \
            if spec.attn_type == "local" else shape.seq_len
        if shape.kind == "prefill":
            base += 2 * 2 * shape.global_batch * shape.seq_len * ctx_len * \
                cfg.n_heads * cfg.head_dim * 0.5 * cfg.n_superblocks
        else:
            base += 2 * 2 * shape.global_batch * ctx_len * cfg.n_heads * \
                cfg.head_dim * cfg.n_superblocks
    if shape.kind == "prefill":
        base = 2.0 * n_active * shape.global_batch * shape.seq_len + base \
            - 2.0 * n_active * shape.global_batch
    return base


@dataclasses.dataclass
class DryTarget:
    """A rank's step ``fn`` and its arguments ``args`` (meta tensors; the
    batch global, as every rank passes it), with ``resident``: the bytes
    of the rank's blocks that live before the step (``params``,
    ``opt_state``, ``batch``, ``caches``), whose sum is the dry run's
    ``memory_per_device.arguments``."""
    fn: Callable
    args: Tuple[Any, ...]
    resident: Dict[str, int]


def dry_target(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               hp: Optional[TrainHParams] = None,
               param_dtype=torch.bfloat16, rules_override=None,
               **ctx_opts) -> DryTarget:
    """The counterpart of the reference's ``lower_target``: the step of
    rank ``mesh.rank`` of ``mesh`` and its arguments on ``meta``.

    ``train``: ``make_train_step(cfg, hp, ctx)`` (``hp`` by default remat
    "full", ``ce_chunk`` 1024), the parameters' and optimiser state's
    blocks (AdamW or ``adamw8bit``, ``hp.opt_impl``) and a 0-d int32
    step; ``prefill``: ``make_prefill_step`` into caches of ``seq_len``;
    ``decode``: ``make_serve_step``, one new token at position
    ``seq_len - 1`` against the rank's blocks of caches of ``seq_len``
    (``sharding.cache_specs``)."""
    ctx = make_ctx(mesh, cfg, shape, rules_override, **ctx_opts)
    params = param_blocks(cfg, ctx, param_dtype)
    b_specs, b_shards = batch_specs(cfg, shape, ctx, dtype=param_dtype)
    batch = {k: _meta(a.shape, a.dtype) for k, a in b_specs.items()}
    resident = {
        "params": tree_bytes(params),
        "batch": sum(Abstract(ctx.block_shape(a.shape, b_shards[k]),
                              a.dtype).nbytes
                     for k, a in b_specs.items()),
    }

    if shape.kind == "train":
        hp = hp or TrainHParams(remat="full", ce_chunk=1024)
        fn = make_train_step(cfg, hp, ctx)
        opt = opt_blocks(cfg, ctx, hp.opt_impl)
        step = _meta((), torch.int32)
        resident["opt_state"] = tree_bytes(opt)
        return DryTarget(fn, (params, opt, batch, step), resident)

    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, ctx, max_len=shape.seq_len)
        return DryTarget(fn, (params, batch), resident)

    S = shape.seq_len
    caches = M.init_caches(cfg, shape.global_batch, S, param_dtype,
                           device="meta", ctx=ctx)
    resident["caches"] = tree_bytes(caches)
    fn = make_serve_step(cfg, ctx)
    return DryTarget(fn, (params, batch, caches, S - 1), resident)
