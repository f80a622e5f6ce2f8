"""Composable decoder model of the serving path: parameter specs, the
super-block loop, prefill and single-token decode.  The port of the
reference's ``models/model.py``.

Parameters are a plain dict of tensors in the reference's layout:
``embed`` (V, d), ``final_ln`` (d,), ``blocks`` (one dict per position of
``cfg.pattern``, each tensor stacked on a leading layer dimension of
``cfg.n_superblocks``) and ``lm_head`` (d, V) unless the embeddings are
tied.  Caches are one (k, v) or (conv_tail, ssm_state) pair per pattern
position, stacked the same way.  Every architecture of the registry runs:
dense and MoE MLPs, attention and SSD mixers, RoPE and M-RoPE (positions
(3, B, S)), token and ``embeds`` inputs.

Training: ``loss_fn`` runs the stack in train mode, then the final norm
and ``chunked_ce_loss`` (cross-entropy a sequence chunk at a time, so the
(B, S, V) logits are never whole), plus the MoE router's aux loss.
``run_stack`` takes the reference's remat options: ``"full"`` wraps each
super-block in a non-reentrant ``torch.utils.checkpoint``; ``"dots"``
and ``"dots_no_batch"`` are selective checkpoints that keep the outputs
of matrix products (``mm``/``bmm``/``addmm``, or ``mm``/``addmm``) and
recompute the rest; ``remat_segment`` > 1 checkpoints segments of
super-blocks as well.  Remat changes memory, never values.  Under a
``models.sharding.RankLayout`` the loss runs on one rank's rows and
parameter blocks, with the collectives of tensor, expert and FSDP
parallelism (``run_stack``, ``embed_inputs``, ``chunked_ce_loss``).

Serving under a ``models.sharding.ShardingCtx`` (``prefill``,
``decode_step`` and ``forward_hidden`` with ``ctx=``): every rank of
``ctx.mesh`` calls with the same global batch, its own blocks of the
parameters (``sharding.shard_params``) and of the caches
(``sharding.RankCaches``, from ``init_caches(ctx=)`` or
``sharding.shard_caches``).  It runs on its rows, its block of d_model
where the ``embed`` rule splits it (the 2-D no-regather tables, with
``gather_fsdp=False``: no parameter is gathered, partial products of
activation rows are summed) and its block of the KV cache's positions
where ``kv_seq`` splits them (a distributed softmax in decode); the
logits are vocab-parallel, then gathered, so every rank returns the
same (B, V) float32 logits.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.models import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamSpec, init_params
from repro_torch.models.sharding import (RankCaches, RankLayout,
                                         cache_shapes, cache_specs,
                                         check_ctx)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    return {
        "wq": ParamSpec((d, Hq, D), "normal", s,
                        ("embed_fsdp", "heads", None)),
        "wk": ParamSpec((d, Hkv, D), "normal", s,
                        ("embed_fsdp", "kv_heads", None)),
        "wv": ParamSpec((d, Hkv, D), "normal", s,
                        ("embed_fsdp", "kv_heads", None)),
        "wo": ParamSpec((Hq, D, d), "normal", (Hq * D) ** -0.5,
                        ("heads", None, "embed_fsdp")),
    }


def _ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    gn = s.n_groups * s.d_state
    H = d_in // s.head_dim
    sc = d ** -0.5
    return {
        "in_z": ParamSpec((d, d_in), "normal", sc, ("embed_fsdp", "ssm_in")),
        "in_x": ParamSpec((d, d_in), "normal", sc, ("embed_fsdp", "ssm_in")),
        "in_B": ParamSpec((d, gn), "normal", sc, ("embed_fsdp", None)),
        "in_C": ParamSpec((d, gn), "normal", sc, ("embed_fsdp", None)),
        "in_dt": ParamSpec((d, H), "normal", sc, ("embed_fsdp", None)),
        "conv_w": ParamSpec((s.d_conv, d_in + 2 * gn), "normal", 0.2,
                            (None, "ssm_in")),
        "conv_b": ParamSpec((d_in + 2 * gn,), "zeros", 1.0, ("ssm_in",)),
        "A_log": ParamSpec((H,), "ones", 1.0, (None,)),
        "D": ParamSpec((H,), "ones", 1.0, (None,)),
        "dt_bias": ParamSpec((H,), "zeros", 1.0, (None,)),
        "gate_ln": ParamSpec((d_in,), "zeros", 1.0, ("ssm_in",)),
        "out_proj": ParamSpec((d_in, d), "normal", d_in ** -0.5,
                              ("ssm_in", "embed_fsdp")),
    }


def _mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamSpec((d, f), "normal", d ** -0.5, ("embed_fsdp", "mlp")),
        "w3": ParamSpec((d, f), "normal", d ** -0.5, ("embed_fsdp", "mlp")),
        "w2": ParamSpec((f, d), "normal", f ** -0.5, ("mlp", "embed_fsdp")),
    }


def _moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    sp = {
        "router": ParamSpec((d, E), "normal", d ** -0.5, ("embed_fsdp", None)),
        "w1": ParamSpec((E, d, f), "normal", d ** -0.5,
                        ("expert", "embed_fsdp", "mlp")),
        "w3": ParamSpec((E, d, f), "normal", d ** -0.5,
                        ("expert", "embed_fsdp", "mlp")),
        "w2": ParamSpec((E, f, d), "normal", f ** -0.5,
                        ("expert", "mlp", "embed_fsdp")),
    }
    if m.n_shared:
        n = m.n_shared
        sp["shared_w1"] = ParamSpec((n, d, f), "normal", d ** -0.5,
                                    (None, "embed_fsdp", "mlp"))
        sp["shared_w3"] = ParamSpec((n, d, f), "normal", d ** -0.5,
                                    (None, "embed_fsdp", "mlp"))
        sp["shared_w2"] = ParamSpec((n, f, d), "normal", f ** -0.5,
                                    (None, "mlp", "embed_fsdp"))
    return sp


def _layer_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    norm = ParamSpec((d,), "zeros", 1.0, (None,))
    out: Dict[str, ParamSpec] = {"ln": norm}
    if spec.kind == "attn":
        out.update(_attn_specs(cfg))
    else:
        out.update(_ssm_specs(cfg))
    if cfg.use_post_norm:
        out["ln_post"] = norm
    if spec.mlp != "none":
        out["ln_mlp"] = norm
        if cfg.use_post_norm:
            out["ln_mlp_post"] = norm
        mlp = _mlp_specs(cfg) if spec.mlp == "dense" else _moe_specs(cfg)
        out.update({f"mlp_{k}": v for k, v in mlp.items()})
    return out


def _stack(spec_dict: Dict[str, ParamSpec], n: int) -> Dict[str, ParamSpec]:
    return {k: ParamSpec((n,) + v.shape, v.init, v.scale,
                         ("layers",) + v.axes)
            for k, v in spec_dict.items()}


# vocab-only sharding of the table, as the reference's: a 2-axis-sharded
# table would reshard its token gather; d_model stays replicated
EMBED_AXES = ("vocab", None)
LM_HEAD_AXES = ("embed_fsdp", "vocab")


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), "normal", 1.0,
                           EMBED_AXES),
        "final_ln": ParamSpec((cfg.d_model,), "zeros", 1.0, (None,)),
        "blocks": [_stack(_layer_specs(cfg, spec), cfg.n_superblocks)
                   for spec in cfg.pattern],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), "normal",
                                    cfg.d_model ** -0.5, LM_HEAD_AXES)
    return tree


# ---------------------------------------------------------------------------
# Layer / super-block application
# ---------------------------------------------------------------------------


def _apply_layer(cfg, spec: LayerSpec, p, x, positions, *, mode, cache,
                 cur_len, attn_impl, shard=None, moe=(1, False)):
    layout, specs = shard or (None, None)
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps, layout)
    if spec.kind == "attn":
        out, new_cache = L.attention_block(
            p, h, positions, cfg, spec, kv_cache=cache, cur_len=cur_len,
            attn_impl=attn_impl, mode=mode, layout=layout, specs=specs)
    else:
        out, new_cache = S.mamba2_block(p, h, cfg, cache=cache, mode=mode,
                                        layout=layout, specs=specs)
    if cfg.use_post_norm:
        out = L.rmsnorm(out, p["ln_post"], cfg.norm_eps, layout)
    x = x + out
    stats = None
    if spec.mlp != "none":
        h2 = L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps, layout)
        mp = {k[4:]: v for k, v in p.items() if k.startswith("mlp_")}
        ms = specs and {k[4:]: v for k, v in specs.items()
                        if k.startswith("mlp_")}
        if spec.mlp == "dense":
            out2 = L.mlp_block(mp, h2, cfg, layout, ms)
        elif layout is not None and layout.ctx.moe_impl == "ep":
            out2, stats = L.moe_block_ep(mp, h2, cfg, layout, ms,
                                         with_stats=mode == "train")
        else:
            out2, stats = L.moe_block(mp, h2, cfg,
                                      with_stats=mode == "train",
                                      groups=moe[0], group_aux=moe[1],
                                      layout=layout, specs=ms)
        if cfg.use_post_norm:
            out2 = L.rmsnorm(out2, p["ln_mlp_post"], cfg.norm_eps, layout)
        x = x + out2
    return x, new_cache, stats


REMATS = (None, "full", "dots", "dots_no_batch")
# the products whose outputs the selective remats keep (the reference's
# ``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims``)
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default),
}


def _save_products(ops, ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, remat: Optional[str]):
    """``fn`` under the remat option ``remat`` (the identity for None)."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}; allowed: {REMATS}")
    if remat is None:
        return fn
    kw = {}
    if remat != "full":
        policy = functools.partial(_save_products, _SAVED_OPS[remat])
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _add_stats(acc, stats):
    if stats is None:
        return acc
    return stats if acc is None else {k: acc[k] + v for k, v in stats.items()}


def _layer_shards(cfg, layout):
    """Per pattern position, {name: (spec of one layer's slice, its
    logical axes)} under ``layout``'s ctx."""
    out = []
    for spec in cfg.pattern:
        ps = _layer_specs(cfg, spec)
        out.append({k: (layout.ctx.spec_for(v.shape, v.axes), v.axes)
                    for k, v in ps.items()})
    return out


def run_stack(cfg: ModelConfig, params, x, positions, *, mode: str = "train",
              caches=None, cur_len=None, attn_impl: str = "blocked",
              remat: Optional[str] = None, remat_segment: int = 0,
              layout=None, moe=(1, False)):
    """Apply all layers, a Python loop over super-blocks.  Returns
    (hidden, new_caches, stats_sum); new_caches is None in train mode.
    stats_sum holds ``aux_loss`` and, for an MoE config, ``expert_load``,
    summed over the MoE layers as the reference sums them (over a
    super-block's positions, then over super-blocks; the reference's
    other layers add zeros), zeros without MoE layers.  Only train mode
    computes them: prefill and decode return the zeros, since serving
    reads no stats (the reference's jit drops them there as dead code).

    In train mode ``remat`` checkpoints each super-block, and
    ``remat_segment`` > 1 (when it divides the super-blocks into more
    than one segment) each segment of ``remat_segment`` super-blocks too,
    as the reference's sqrt-N remat does.

    A layer whose new cache is the slice of the stacked buffer it was
    given (attention writes its KV in place) leaves the buffer as it is;
    other new caches (the SSD state and conv tail) are stacked afresh, in
    the dtype the layer computed them in, as the reference's scan does.

    With a ``layout`` (``models.sharding.RankLayout``) the parameters
    are this rank's blocks: each layer's FSDP dims (not under a ctx with
    ``gather_fsdp=False``) are all-gathered before it (inside the remat
    region, so the recompute gathers again, in the same order on every
    rank) and freed after it.  In train mode, where the layout's
    ``sp_axes`` split the saved residual's positions (``seq_sp``), each
    super-block's input is this rank's block of them (``seq_block``,
    outside the remat region, so that is what a checkpoint saves) and
    the super-block gathers it first (inside the region: the recompute
    gathers again); the last super-block's output stays whole.
    ``moe`` = (groups, group_aux) is the one-process MoE dispatch's
    grouping (``moe_block``)."""
    train = mode == "train"
    shards = None if layout is None else _layer_shards(cfg, layout)
    sp = layout.sp_axes if (train and layout is not None) else ()

    def enter(x):
        """The residual at a super-block boundary: this rank's block of
        its positions over the ``seq_sp`` axes."""
        return C.seq_block(x, 1, sp, layout.mesh) if sp else x
    # one layer's parameters are views of the stacked tensors: unbind
    # hands back one stacked gradient, not a stack-sized one per layer
    layers = [{k: v.unbind(0) for k, v in blk.items()}
              for blk in params["blocks"]]

    def superblock(x, i):
        if sp:      # the boundary's block, gathered (backward: own block)
            x = C.all_gather(x, 1, sp, layout.mesh)
        acc, runs = None, []
        for pos, spec in enumerate(cfg.pattern):
            p = {k: v[i] for k, v in layers[pos].items()}
            shard = None
            if shards is not None:
                p = {k: layout.gather_leaf(v, *shards[pos][k])
                     for k, v in p.items()}
                shard = (layout, {k: layout.gathered(*shards[pos][k])
                                  for k in p})
            cache = (None if caches is None else
                     tuple(buf[i] for buf in caches[pos]))
            x, ncache, stats = _apply_layer(
                cfg, spec, p, x, positions, mode=mode, cache=cache,
                cur_len=cur_len, attn_impl=attn_impl, shard=shard, moe=moe)
            runs.append((cache, ncache))
            acc = _add_stats(acc, stats)
        return x, acc, runs

    per_layer: List[List[Any]] = [[] for _ in cfg.pattern]
    per_block = []
    n_sb = cfg.n_superblocks
    if train:
        body = remat_wrap(lambda x, i: superblock(x, i)[:2], remat)
        inner = n_sb
        if remat_segment > 1 and n_sb % remat_segment == 0 \
                and n_sb // remat_segment > 1:
            inner = remat_segment

        def segment(x, first):
            accs = []
            for i in range(first, first + inner):
                x, acc = body(x if i == first else enter(x), i)
                accs.append(acc)
            return x, accs

        if inner < n_sb:
            segment = remat_wrap(segment, "full")
        for first in range(0, n_sb, inner):
            x, accs = segment(enter(x), first)
            per_block += [a for a in accs if a is not None]
    else:
        for i in range(n_sb):
            x, acc, runs = superblock(x, i)
            for pos, run in enumerate(runs):
                per_layer[pos].append(run)
            if acc is not None:
                per_block.append(acc)
    if per_block:
        stats_sum = {k: torch.stack([b[k] for b in per_block]).sum(0)
                     for k in per_block[0]}
    else:
        stats_sum = {"aux_loss": x.new_zeros((), dtype=torch.float32)}
        if cfg.moe is not None:
            stats_sum["expert_load"] = x.new_zeros((cfg.moe.n_experts,),
                                                   dtype=torch.float32)
    if train:
        return x, None, stats_sum
    new_caches = []
    for pos, runs in enumerate(per_layer):
        pair = []
        for part in range(2):
            if caches is not None and all(
                    new[part] is old[part] for old, new in runs):
                pair.append(caches[pos][part])
            else:
                pair.append(torch.stack([new[part] for _, new in runs]))
        new_caches.append(tuple(pair))
    return x, new_caches, stats_sum


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _table(cfg, params, layout):
    """The embedding table (V, d) as this rank reads it: gathered over
    the batch's axes, and the axes it stays split over (vocab-parallel)."""
    spec = layout.ctx.spec_for((cfg.vocab_size, cfg.d_model), EMBED_AXES)
    table = layout.gather_leaf(params["embed"], spec, EMBED_AXES)
    return table, layout.tp_axes(layout.gathered(spec, EMBED_AXES)[0])


def embed_inputs(cfg: ModelConfig, params, batch, layout=None):
    """Token embeddings (Gemma's scaling where the embeddings are tied) or
    the ``embeds`` input.  With a ``layout`` whose table is split over
    the vocabulary, each rank looks up the ids in its range, zero
    elsewhere, then one sum over those axes; serving on d_model blocks,
    the table's columns of this rank's block."""
    if cfg.input_mode == "embeds":
        return batch["embeds"]
    return embed_tokens(cfg, params, batch["tokens"], layout,
                        scale=cfg.tie_embeddings)


def embed_tokens(cfg: ModelConfig, params, tokens, layout=None, *,
                 scale: bool = False):
    """The token table's rows of ``tokens`` (see ``embed_inputs``; ``scale``
    multiplies by sqrt(d_model), Gemma's scaling)."""
    tp = ()
    if layout is None:
        x = params["embed"][tokens]
    else:
        table, tp = _table(cfg, params, layout)
        if layout.embed_axes:
            ex, mesh = layout.embed_axes, layout.mesh
            table = C.own_block(C.copy_to(table, ex, mesh), 1, ex, mesh)
    if tp:
        v_loc = table.shape[0]
        ids = tokens.long() - layout.mesh.block_index(tp) * v_loc
        inside = (ids >= 0) & (ids < v_loc)
        x = torch.where(inside[..., None], table[ids.clamp(0, v_loc - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        x = C.all_reduce(x, tp, layout.mesh)
    elif layout is not None:
        x = table[tokens]
    if scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)  # gemma
    return x


def _lm_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T      # (d, V)
    return params["lm_head"]


def _logits(cfg, params, hidden_last, layout=None):
    """(B, d) last hidden states -> (B, V) float32 logits.  With a serving
    ``layout``: this rank's rows and block of d_model against its block
    of the LM matrix, the partial products summed over the d axes, the
    vocabulary's blocks then gathered and the rows too, so that every
    rank returns the whole batch's logits."""
    if layout is None:
        logits = torch.matmul(hidden_last.float(),
                              _lm_matrix(cfg, params).float())
    else:
        if cfg.tie_embeddings:
            table, v_ax = _table(cfg, params, layout)
            w, d_entry = table.T, None
        else:
            spec = layout.ctx.spec_for((cfg.d_model, cfg.vocab_size),
                                       LM_HEAD_AXES)
            w = layout.gather_leaf(params["lm_head"], spec, LM_HEAD_AXES)
            after = layout.gathered(spec, LM_HEAD_AXES)
            d_entry, v_ax = after[0], layout.tp_axes(after[1])
        hu, (wu,), red = L.contract_d(hidden_last.float(), [w.float()], 0,
                                      layout, d_entry)
        logits = C.reduce(torch.matmul(hu, wu), red, layout.mesh)
        logits = C.gather(logits, 1, v_ax, layout.mesh)
        logits = C.gather(logits, 0, layout.batch_axes, layout.mesh)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _lm_shard(cfg, params, layout):
    """The LM matrix (d, V) as this rank reads it, the spec entry of its
    d and the axes its vocabulary stays split over."""
    if cfg.tie_embeddings:
        table, tp = _table(cfg, params, layout)
        return table.T, None, tp
    spec = layout.ctx.spec_for((cfg.d_model, cfg.vocab_size), LM_HEAD_AXES)
    w = layout.gather_leaf(params["lm_head"], spec, LM_HEAD_AXES)
    after = layout.gathered(spec, LM_HEAD_AXES)
    return w, after[0], layout.tp_axes(after[1])


def chunked_ce_loss(cfg: ModelConfig, params, hidden, targets, *,
                    chunk: int = 1024, mask=None, layout=None):
    """Mean cross-entropy of ``targets`` (B, S) under the LM head over
    ``hidden`` (B, S, d), a chunk of ``chunk`` positions at a time (float32
    logits of (B, chunk, V) at once), the chunks' sums added in order from
    0 as the reference's scan adds them; ``mask`` (B, S) weights the
    positions (the count of weighted positions divides).

    With a ``layout``: the rows are this rank's; on d_model blocks (the
    ``embed`` axes, or an LM matrix whose d stays split) the logits are
    one partial product summed over those axes (``layers.contract_d``);
    where the LM matrix's vocabulary is split, the logsumexp is
    distributed (a max, then a sum of the shifted exponentials, over
    those axes) and the target's logit comes from the rank that owns it;
    the sums and the count are then summed over the batch's ranks, so
    every rank holds the global mean and its gradient is this rank's
    share."""
    B, S_, d = hidden.shape
    c = min(chunk, S_)
    if S_ % c:
        raise ValueError(f"sequence {S_} is not a multiple of the CE chunk "
                         f"{c}")
    tp, red = (), ()
    if layout is None:
        w = _lm_matrix(cfg, params).float()
    else:
        mesh = layout.mesh
        w, d_entry, tp = _lm_shard(cfg, params, layout)
        hidden, (w,), red = L.contract_d(C.copy_to(hidden, tp, mesh),
                                         [w.float()], 0, layout, d_entry)
        if tp:
            lo = mesh.block_index(tp) * w.shape[1]
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ntok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a in range(0, S_, c):
        logits = torch.matmul(hidden[:, a:a + c].float(), w)
        if red:
            logits = C.all_reduce(logits, red, mesh)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits
                                                    / cfg.final_softcap)
        tc = targets[:, a:a + c, None].long()
        if tp:
            m = C.all_reduce_max(logits.max(-1).values, tp, mesh)
            lse = m + torch.log(C.all_reduce(
                torch.exp(logits - m[..., None]).sum(-1), tp, mesh))
            t_loc = tc - lo
            inside = (t_loc >= 0) & (t_loc < w.shape[1])
            ll = torch.where(inside, torch.gather(
                logits, -1, t_loc.clamp(0, w.shape[1] - 1)),
                torch.zeros((), device=logits.device))[..., 0]
            ll = C.all_reduce(ll, tp, mesh)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, tc)[..., 0]
        mc = (torch.ones_like(lse) if mask is None
              else mask[:, a:a + c].float())
        loss = loss + ((lse - ll) * mc).sum()
        ntok = ntok + mc.sum()
    if layout is not None and layout.batch_axes:
        loss = C.all_reduce(loss, layout.batch_axes, layout.mesh)
        ntok = C.reduce(ntok, layout.batch_axes, layout.mesh)
    return loss / torch.clamp(ntok, min=1.0)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def make_positions(cfg: ModelConfig, B: int, S: int, offset=0, device=None):
    """(B, S) int32 positions from ``offset``; (3, B, S) under M-RoPE, the
    same positions on the temporal, height and width axes."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(B, S)
    return pos.expand(3, B, S) if cfg.mrope else pos


def loss_fn(cfg: ModelConfig, params, batch, *, attn_impl="blocked",
            remat=None, ce_chunk=1024, remat_segment=0, layout=None,
            moe_groups=1, moe_group_aux=False):
    """Training loss.  batch: ``tokens`` (B, S) or ``embeds`` (B, S, d),
    ``targets`` (B, S), optional ``positions`` and ``loss_mask``.
    Returns (loss, metrics): the mean cross-entropy plus, for an MoE
    config, ``router_aux_weight * aux_loss / n_layers``; metrics ``ce``,
    ``aux_loss`` and, for an MoE config, ``expert_load`` (E,).

    With a ``layout`` the batch is this rank's rows and ``params`` its
    blocks; the loss and metrics are the whole batch's, equal on every
    rank.  ``moe_groups`` and ``moe_group_aux`` set the one-process MoE
    dispatch's grouping (``layers.moe_block``)."""
    x = embed_inputs(cfg, params, batch, layout)
    B, S_ = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S_, device=x.device)
    hidden, _, stats = run_stack(cfg, params, x, positions, mode="train",
                                 attn_impl=attn_impl, remat=remat,
                                 remat_segment=remat_segment, layout=layout,
                                 moe=(moe_groups, moe_group_aux))
    hidden = L.rmsnorm(hidden, params["final_ln"], cfg.norm_eps, layout)
    ce = chunked_ce_loss(cfg, params, hidden, batch["targets"],
                         chunk=ce_chunk, mask=batch.get("loss_mask"),
                         layout=layout)
    aux = stats["aux_loss"]
    aux = aux.sum() if aux.dim() else aux
    total = ce
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_weight * aux / cfg.n_layers
    metrics = {"ce": ce, "aux_loss": aux}
    if cfg.moe is not None:
        load = stats["expert_load"]
        metrics["expert_load"] = load.sum(0) if load.dim() > 1 else load
    return total, metrics


def init_caches(cfg: ModelConfig, B: int, max_len: int,
                dtype=torch.bfloat16, device=None, ctx=None):
    """Per-position stacked cache buffers (leading dim n_superblocks); the
    SSM state in float32.  With ``ctx``, this rank's blocks of them
    (``sharding.cache_specs``), as ``sharding.RankCaches``."""
    caches = []
    specs = (cache_specs(cfg, ctx, B, max_len) if ctx is not None
             else [(None, None)] * len(cfg.pattern))
    for spec, shapes, sp in zip(cfg.pattern, cache_shapes(cfg, B, max_len),
                                specs):
        dtypes = (dtype, dtype if spec.kind == "attn" else torch.float32)
        caches.append(tuple(
            torch.zeros(shape if s_ is None else ctx.block_shape(shape, s_),
                        dtype=dt, device=device)
            for shape, s_, dt in zip(shapes, sp, dtypes)))
    return caches if ctx is None else RankCaches(caches, max_len)


def rank_batch(batch, layout):
    """This rank's part of a global serving batch: its rows of
    ``tokens`` / ``embeds`` / ``positions`` ((B, S) or (3, B, S)), and its
    block of the embeddings' d_model."""
    out = {}
    for k, v in batch.items():
        if k == "positions":
            v = layout.rows(v, v.dim() - 2)
        elif k in ("tokens", "embeds"):
            v = layout.rows(v)
            if k == "embeds" and layout.embed_axes:
                v = C.own_block(v, -1, layout.embed_axes, layout.mesh)
        out[k] = v
    return out


def _forward(cfg, params, batch, ctx, *, mode, caches, cur_len, attn_impl):
    """``forward_hidden`` and the layout it ran under (None without a
    ctx)."""
    layout = None
    if ctx is not None:
        check_ctx(cfg, ctx)
        if not isinstance(caches, RankCaches):
            raise TypeError("under a sharding context the caches are this "
                            "rank's blocks, a sharding.RankCaches")
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        layout = RankLayout.for_serving(ctx, cfg, x.shape[0],
                                        caches.max_len)
        batch = rank_batch(batch, layout)
    x = embed_inputs(cfg, params, batch, layout)
    B, S_ = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S_, offset=cur_len or 0,
                                   device=x.device)
    hidden, new_caches, _ = run_stack(cfg, params, x, positions, mode=mode,
                                      caches=caches, cur_len=cur_len,
                                      attn_impl=attn_impl, layout=layout)
    hidden = L.rmsnorm(hidden, params["final_ln"], cfg.norm_eps, layout)
    if layout is not None:
        new_caches = RankCaches(new_caches, caches.max_len)
    return hidden, new_caches, layout


def forward_hidden(cfg, params, batch, ctx=None, *, mode, caches, cur_len,
                   attn_impl="blocked"):
    """The final-normed hidden states and the new caches; under ``ctx``
    this rank's rows and block of d_model, and its cache blocks."""
    hidden, new_caches, _ = _forward(cfg, params, batch, ctx, mode=mode,
                                     caches=caches, cur_len=cur_len,
                                     attn_impl=attn_impl)
    return hidden, new_caches


def decode_step(cfg: ModelConfig, params, batch, caches, cur_len, ctx=None):
    """One-token decode. batch: tokens (B, 1) or embeds (B, 1, d), and
    ``positions`` ((3, B, 1) under M-RoPE) unless the default ones from
    ``cur_len`` apply.  Returns
    (next_token_logits (B, V) float32, new_caches).  The KV buffers of
    ``caches`` are written in place.  Under ``ctx`` (see the module's
    note) ``params`` and ``caches`` are this rank's blocks and the logits
    the whole batch's, the same on every rank."""
    hidden, new_caches, layout = _forward(
        cfg, params, batch, ctx, mode="decode", caches=caches,
        cur_len=int(cur_len), attn_impl="blocked")
    return _logits(cfg, params, hidden[:, -1], layout), new_caches


def prefill(cfg: ModelConfig, params, batch, max_len: int, ctx=None,
            attn_impl="blocked", cache_dtype=torch.bfloat16):
    """Run the prompt (``tokens`` (B, S) or ``embeds`` (B, S, d), as
    ``cfg.input_mode`` says, and optional ``positions``), returning
    (last_hidden, primed caches, prompt_len).  Under ``ctx`` the hidden
    states are this rank's rows and block of d_model and the caches its
    blocks (``sharding.RankCaches``)."""
    hidden, new_caches, _ = _prefill(cfg, params, batch, max_len, ctx,
                                     attn_impl, cache_dtype)
    return hidden, new_caches, _prompt_len(batch)


def _prompt_len(batch) -> int:
    return batch.get("tokens", batch.get("embeds")).shape[1]


def _prefill(cfg, params, batch, max_len, ctx, attn_impl, cache_dtype):
    x = batch["tokens"] if cfg.input_mode == "tokens" else batch["embeds"]
    caches = init_caches(cfg, x.shape[0], max_len, cache_dtype,
                         device=x.device, ctx=ctx)
    return _forward(cfg, params, batch, ctx, mode="prefill", caches=caches,
                    cur_len=0, attn_impl=attn_impl)


def init_model_params(cfg: ModelConfig,
                      generator: Optional[torch.Generator] = None,
                      dtype=torch.float32, *, device="cuda"):
    """Seeded parameters on ``device`` (the card unless the CPU is asked
    for; raises without a card).  ``generator`` must live on ``device``;
    by default it is one seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}")
    return init_params(param_specs(cfg), generator, dtype)
