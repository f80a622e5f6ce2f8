"""Logical-axis sharding over the ranks of a ``torch.distributed`` world
(the port of the reference's ``models/sharding.py``).

Every parameter carries logical axis names (``ParamSpec.axes``); a rules
table maps a logical axis to mesh axes.  ``ShardingCtx.spec_for`` gives
a tensor's spec, one entry a dim: None (replicated), a mesh axis or a
tuple of mesh axes, the content of the reference's ``PartitionSpec``.
A mesh axis applies only when the product of the axes' sizes divides
the dim (the longest prefix of the rule's axes that divides it), and a
mesh axis used by an earlier dim is dropped from a later one.  It reads
only the mesh's axis sizes, so ``spec_for_shape`` gives it for a shape
dict without ranks.

Where the reference lets GSPMD place data and collectives, the port
places them itself: each rank holds the block of every tensor that its
spec gives it (``shard_params``, row-major over each dim's axes as
``launch.mesh.Mesh.block_index`` orders them), and the layers run the
collectives of ``models.collectives``.  ``RankLayout`` is what the layers
read: the ctx, the mesh axes the batch rows are split over (the batch
dim's spec for this batch size) and, for a parameter, which dims are
gathered before use (``gather_leaf``) and which stay split over the
model axes.

Training runs every table, with either ``gather_fsdp``, ``moe_impl``
'dense' or 'ep', attention, SSM and hybrid archs and either optimiser
(``check_ctx`` refuses only an unknown ``moe_impl``, as the reference
does).  ``RankLayout.for_batch`` with the config and the
sequence length gives a training rank what it reads: the batch axes
(empty where ``batch`` is None: every rank holds every row), the
``embed`` axes of the activations' d_model (the 2-D tables) and the
``seq_sp`` axes of the residual saved at each super-block boundary.
``kv_seq`` splits nothing in training (no cache), and no table maps
``seq``.  ``opt_shardings`` lays out the optimiser state as the
reference's ``launch/specs.py`` ``opt_specs`` does: AdamW's moments as
the parameters, the int8 state's codes as the parameter and its scales
on the parameter's axes, the reduced last dim falling back to
replication where it no longer divides.

Serving (prefill and decode) runs every table, the five serving tables
with the ``gather_fsdp`` the reference pairs them with (False for
``DECODE_2D_RULES`` and ``LONG_2D_RULES``), and ``moe_impl`` 'dense' or
'ep'.  ``RankLayout.for_serving`` adds what a serving rank reads: the
``embed`` axes that split the activations' d_model (the residual stream,
norms and every projection work on this rank's block of it, partial
products summed over those axes) and the ``kv_seq`` axes that split the
KV cache's positions (each rank holds ``max_len / n`` of them; decode
combines the ranks' partial softmaxes).  ``cache_specs`` is the
reference's ``cache_logical_axes`` laid out; ``shard_caches`` /
``gather_caches`` move between the reference's ``init_caches`` layout
and a rank's blocks, which travel as ``RankCaches`` (the blocks and the
global ``max_len`` they are blocks of).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.params import ParamSpec

Rules = Dict[Optional[str], Optional[Tuple[str, ...]]]
Spec = Tuple[Any, ...]

# Production default: DP over (pod, data), FSDP params over data, TP over
# model.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": None,     # sequence sharding of SAVED layer boundaries only
    "kv_seq": None,
    "embed": None,
    "embed_fsdp": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "ssm_in": ("model",),
    "layers": None,
    "conv": None,
    "state": None,
    "groups": None,
    None: None,
}

# Small-model training: the 'model' axis is spent on data parallelism.
SMALL_MODEL_RULES: Rules = dict(
    DEFAULT_RULES,
    batch=("pod", "data", "model"),
    heads=None, kv_heads=None, mlp=None, expert=None, ssm_in=None,
    vocab=("model",),
)

# Serving (decode): the KV cache shards its seq dim over 'model'.
SERVE_RULES: Rules = dict(DEFAULT_RULES, kv_seq=("model",), kv_heads=None)

# Small models at decode: TP stays, FSDP is dropped.
SMALL_SERVE_RULES: Rules = dict(SERVE_RULES, embed_fsdp=None)

# Long-context decode (global_batch=1): context-parallel KV on every axis.
LONG_CONTEXT_RULES: Rules = dict(
    DEFAULT_RULES,
    batch=None,
    kv_seq=("pod", "data", "model"),
    kv_heads=None,
    seq=None,
)

# Decode for big dense models: weights stay 2-D sharded, never gathered;
# activations shard d_model over 'data'.
DECODE_2D_RULES: Rules = dict(
    DEFAULT_RULES,
    batch=None,
    embed=("data",),
    kv_seq=("data", "model"),
    kv_heads=None,
)

# Sequence-parallel saved boundaries.
TRAIN_SP_RULES: Rules = dict(DEFAULT_RULES, seq_sp=("model",))

# ZeRO across pods: params shard over both the pod and data axes.
FSDP_POD_RULES: Rules = dict(DEFAULT_RULES, embed_fsdp=("pod", "data"))

# Long-context decode with the 2-D no-regather treatment.
LONG_2D_RULES: Rules = dict(LONG_CONTEXT_RULES, embed=("data",))

NAMED_RULES = {
    "default": None,
    "decode2d": DECODE_2D_RULES,
    "long": LONG_CONTEXT_RULES,
    "long2d": LONG_2D_RULES,
    "serve": SERVE_RULES,
    "small": SMALL_MODEL_RULES,
    "train_sp": TRAIN_SP_RULES,
    "fsdp_pod": FSDP_POD_RULES,
}

MOE_IMPLS = ("dense", "ep")


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_for_shape(mesh_shape: Dict[str, int], rules: Rules,
                   shape: Sequence[int],
                   axes: Sequence[Optional[str]]) -> Spec:
    """The reference's ``ShardingCtx.spec_for`` on a mesh of axis sizes
    ``mesh_shape``: one entry a dim, None, an axis name or a tuple of
    names (a single axis given as its name, as ``PartitionSpec`` keeps
    it)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         "differ in length")

    def size(names):
        return math.prod(mesh_shape[n] for n in names)
    parts = []
    for dim, ax in zip(shape, axes):
        mesh_axes = rules.get(ax)
        if not mesh_axes:
            parts.append(None)
            continue
        mesh_axes = tuple(m for m in mesh_axes if m in mesh_shape)
        # divisibility fallback: the longest prefix that divides the dim
        while mesh_axes and dim % size(mesh_axes) != 0:
            mesh_axes = mesh_axes[:-1]
        if mesh_axes:
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        else:
            parts.append(None)
    # a mesh axis is used once; later dims lose
    used, clean = set(), []
    for p in parts:
        tup = entry_axes(p)
        if any(t in used for t in tup):
            clean.append(None)
        else:
            used.update(tup)
            clean.append(p)
    return tuple(clean)


@dataclasses.dataclass
class ShardingCtx:
    """Mesh + rules.  ``mesh`` is a ``launch.mesh.Mesh`` (or any object
    with its ``shape`` dict of axis sizes, enough for ``spec_for``).

    gather_fsdp: gather the FSDP-sharded weight dims before each layer
    (training's semantics); False keeps them split and sums partial
    products of the activations instead (decode's trade).
    moe_impl: 'dense' (the dispatch in groups of the batch's shards,
    experts or their d_ff split over 'model') or 'ep' (each data shard
    routes its own tokens to the rank's E / ep experts; one sum over
    'model')."""

    mesh: Any
    rules: Rules
    gather_fsdp: bool = True
    moe_impl: str = "dense"

    def axis_size(self, names) -> int:
        return math.prod(self.mesh.shape[n] for n in entry_axes(names))

    def spec_for(self, shape: Sequence[int],
                 axes: Sequence[Optional[str]]) -> Spec:
        return spec_for_shape(self.mesh.shape, self.rules, shape, axes)

    def block_shape(self, shape: Sequence[int], spec: Spec) -> Tuple[int, ...]:
        """The shape of one rank's block of a tensor of ``shape``."""
        return tuple(n // self.axis_size(entry_axes(e))
                     for n, e in zip(shape, spec))


def constrain(x: torch.Tensor, shape: Sequence[int],
              axes: Sequence[Optional[str]], ctx: Optional[ShardingCtx]):
    """The reference's layout constraint.  Without a ctx, the identity;
    with one, a check that ``x`` is this rank's block of a tensor of the
    global ``shape`` laid out by ``axes`` (the port's layout is explicit,
    so nothing moves)."""
    if ctx is None:
        return x
    want = ctx.block_shape(shape, ctx.spec_for(shape, axes))
    if tuple(x.shape) != want:
        raise ValueError(f"local block {tuple(x.shape)} is not the block "
                         f"{want} of {tuple(shape)} laid out as {tuple(axes)}")
    return x


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def _spec_map(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, tree[k]) for k in sorted(tree)}
    return type(tree)(_spec_map(fn, v) for v in tree)


def spec_leaves(tree) -> list:
    """The leaves of a tree of ``ParamSpec`` or of specs (whose tuples
    are leaves), in the parameters' leaf order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in spec_leaves(v)]
    return [tree]


def param_shardings(spec_tree, ctx: ShardingCtx):
    """The spec of every parameter of a ``ParamSpec`` tree (the
    reference's ``param_shardings``, a spec tuple in place of each
    ``NamedSharding``)."""
    return _spec_map(lambda s: ctx.spec_for(s.shape, s.axes), spec_tree)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tensor tree and its spec tree (a spec is
    a tuple, so the spec tree is walked by the tensor tree's shape)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], specs[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not torch.is_tensor(tree):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view
    where it can be)."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = t.shape[dim] // mesh.size(axes)
        t = t.narrow(dim, mesh.block_index(axes) * n, n)
    return t


def owned_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` as a tensor of its own: a contiguous
    copy wherever the spec splits ``t`` (a view, even a contiguous one
    such as a block of rows, would keep the whole of ``t``'s storage
    alive), ``t`` itself where it does not."""
    b = local_block(t, spec, mesh)
    return t if b.shape == t.shape else b.clone(
        memory_format=torch.contiguous_format)


def shard_params(full_tree, ctx: ShardingCtx, specs):
    """This rank's blocks (``owned_block``) of every leaf of the full
    tree ``full_tree``, laid out by ``specs`` (``param_shardings``)."""
    return _zip_map(lambda t, s: owned_block(t, s, ctx.mesh), full_tree,
                    specs)


def gather_params(local_tree, ctx: ShardingCtx, specs):
    """The full tree back from every rank's blocks (an all-gather of each
    sharded dim, counted in ``models.collectives``); every rank must
    call it, in the same order."""
    from repro_torch.models.collectives import gather_full
    return _zip_map(lambda t, s: gather_full(t.detach(), s, ctx.mesh),
                    local_tree, specs)


def opt_shardings(spec_tree, ctx: ShardingCtx, opt_impl: str = "adamw"):
    """The spec of every optimiser-state leaf (the reference's
    ``opt_specs``' shardings): ``{"m": specs, "v": specs}`` for AdamW;
    for ``adamw8bit`` the parameters' tree with, a leaf, ``m_q``/``v_q``
    laid out as the parameter and ``m_s``/``v_s`` (its scales, one per
    128 of the last dim) on the parameter's axes, through ``spec_for``,
    so the reduced last dim falls back where it no longer divides."""
    if opt_impl == "adamw":
        sh = param_shardings(spec_tree, ctx)
        return {"m": sh, "v": sh}
    if opt_impl != "adamw8bit":
        raise ValueError(f"opt_impl={opt_impl!r}; allowed: 'adamw', "
                         "'adamw8bit'")

    def leaf(s):
        q, sc = q8_specs(s, ctx)
        return {"m_q": q, "m_s": sc, "v_q": q, "v_s": sc}
    return _spec_map(leaf, spec_tree)


def q8_specs(s: ParamSpec, ctx: ShardingCtx) -> Tuple[Spec, Spec]:
    """(the codes' spec, the scales' spec) of parameter ``s``'s int8
    state (``opt_shardings``)."""
    from repro_torch.optim.quantized import scale_shape
    sshape = scale_shape(s.shape)
    saxes = (tuple(s.axes) if len(sshape) == len(s.shape)
             else tuple(s.axes) + (None,))[:len(sshape)]
    return ctx.spec_for(s.shape, s.axes), ctx.spec_for(sshape, saxes)


def check_ctx(cfg, ctx: ShardingCtx):
    """Raise for what the reference refuses under a ctx, in training and
    serving alike: an unknown ``moe_impl`` (its ``_apply_layer`` reads
    any other value as 'dense'; the port names the two).  Every rules
    table trains and serves, with either ``gather_fsdp``, attention, SSM
    and hybrid layers and ``moe_impl`` 'dense' or 'ep' (the reference's
    prefill and decode run 'ep' under ``SERVE_RULES`` and
    ``DECODE_2D_RULES`` on 8 host devices)."""
    if ctx.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl={ctx.moe_impl!r}; allowed: {MOE_IMPLS}")


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)
TAIL_AXES = ("layers", "batch", None, "ssm_in")
STATE_AXES = ("layers", "batch", "ssm_in", None, None)


def cache_shapes(cfg, B: int, max_len: int) -> list:
    """The shapes of the reference's ``init_caches``: one (k, v) or
    (conv_tail, ssm_state) pair a pattern position, stacked on
    ``n_superblocks``."""
    n, out = cfg.n_superblocks, []
    for spec in cfg.pattern:
        if spec.kind == "attn":
            kv = (n, B, max_len, cfg.n_kv_heads, cfg.head_dim)
            out.append((kv, kv))
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            out.append(((n, B, s.d_conv - 1, conv_dim),
                        (n, B, d_in // s.head_dim, s.head_dim, s.d_state)))
    return out


def cache_specs(cfg, ctx: ShardingCtx, B: int, max_len: int) -> list:
    """The spec of every cache buffer (the reference's
    ``cache_logical_axes`` under ``ctx``), in ``cache_shapes``'s
    structure."""
    out = []
    for spec, (a, b) in zip(cfg.pattern, cache_shapes(cfg, B, max_len)):
        axes = (KV_AXES, KV_AXES) if spec.kind == "attn" else (TAIL_AXES,
                                                                 STATE_AXES)
        out.append((ctx.spec_for(a, axes[0]), ctx.spec_for(b, axes[1])))
    return out


class RankCaches(list):
    """This rank's cache blocks, a list in ``init_caches``'s structure,
    and the global ``max_len`` they are blocks of (which the decode step
    needs to place its block's positions)."""

    def __init__(self, blocks, max_len: int):
        super().__init__(blocks)
        self.max_len = max_len


def shard_caches(cfg, ctx: ShardingCtx, full, max_len: int) -> RankCaches:
    """This rank's blocks of caches in the reference's layout (``full``,
    as ``init_caches`` makes them for ``max_len`` positions)."""
    B = full[0][0].shape[1]
    return RankCaches(_zip_map(
        lambda t, s: owned_block(t, s, ctx.mesh), list(full),
        cache_specs(cfg, ctx, B, max_len)), max_len)


def gather_caches(cfg, ctx: ShardingCtx, local: RankCaches, B: int) -> list:
    """The caches of a global batch of ``B`` in the reference's layout,
    from every rank's blocks (every rank must call it, in the same
    order)."""
    from repro_torch.models.collectives import gather_full
    return _zip_map(lambda t, s: gather_full(t, s, ctx.mesh), list(local),
                    cache_specs(cfg, ctx, B, local.max_len))


# ---------------------------------------------------------------------------
# What the layers read
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """A ctx bound to one batch: ``batch_axes`` are the mesh axes the
    batch rows are split over (the batch dim's spec for the global batch
    size), in the spec's order; ``batch_size`` is that global size.

    ``embed_axes`` are the axes the activations' d_model is split over
    (the ``embed`` rule), ``kv_axes`` (serving, ``for_serving``) the
    axes the KV cache's ``max_len`` positions are split over (the
    ``kv_seq`` entry of ``cache_specs``) and ``sp_axes`` (training,
    ``for_batch`` given the sequence length) the axes the residual saved
    at a super-block boundary splits its positions over (the ``seq_sp``
    entry of the reference's ``("batch", "seq_sp", "embed")``
    constraint), each without one-rank axes."""

    ctx: ShardingCtx
    batch_axes: Tuple[str, ...]
    batch_size: int
    embed_axes: Tuple[str, ...] = ()
    kv_axes: Tuple[str, ...] = ()
    max_len: Optional[int] = None
    sp_axes: Tuple[str, ...] = ()

    @classmethod
    def for_batch(cls, ctx: ShardingCtx, batch_size: int, cfg=None,
                  seq_len: Optional[int] = None) -> "RankLayout":
        """The layout of a training step's (micro)batch of
        ``batch_size`` rows; with ``cfg`` and ``seq_len``, its ``embed``
        and ``seq_sp`` axes too (else none)."""
        if cfg is None:
            spec = ctx.spec_for((batch_size,), ("batch",))
            return cls(ctx, entry_axes(spec[0]), batch_size)
        act = ctx.spec_for((batch_size, seq_len, cfg.d_model),
                           ("batch", "seq_sp", "embed"))
        many = lambda e: tuple(a for a in entry_axes(e)  # noqa: E731
                               if ctx.mesh.shape[a] > 1)
        return cls(ctx, entry_axes(act[0]), batch_size, many(act[2]),
                   sp_axes=many(act[1]))

    @classmethod
    def for_serving(cls, ctx: ShardingCtx, cfg, batch_size: int,
                    max_len: int) -> "RankLayout":
        """The layout of a prefill or decode step of ``batch_size`` rows
        into caches of ``max_len`` positions."""
        act = ctx.spec_for((batch_size, 1, cfg.d_model),
                           ("batch", "seq", "embed"))
        kv = ctx.spec_for((1, batch_size, max_len, 1, 1), KV_AXES)
        many = lambda e: tuple(a for a in entry_axes(e)  # noqa: E731
                               if ctx.mesh.shape[a] > 1)
        return cls(ctx, entry_axes(act[0]), batch_size, many(act[2]),
                   many(kv[2]), max_len)

    @property
    def mesh(self):
        return self.ctx.mesh

    @property
    def n_blocks(self) -> int:
        return self.ctx.axis_size(self.batch_axes)

    def rows(self, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``a``'s rows along ``dim``."""
        if not self.batch_axes:
            return a
        n = a.shape[dim] // self.n_blocks
        return a.narrow(dim, self.mesh.block_index(self.batch_axes) * n, n)

    def tp_axes(self, entry) -> Tuple[str, ...]:
        """The axes of a gathered parameter's dim that stay split: those
        of ``entry`` (after ``gathered``) that do not split the batch and
        hold more than one rank."""
        return tuple(a for a in entry_axes(entry)
                     if a not in self.batch_axes and self.mesh.shape[a] > 1)

    def gathered(self, spec: Spec, axes: Sequence[Optional[str]]) -> Spec:
        """The spec a parameter has after ``gather_leaf``: its FSDP dims
        (``embed_fsdp``, gathered whatever their axes, unless
        ``ctx.gather_fsdp`` is False, the reference's ``run_stack``
        keeping them split for decode) and any dim split over a batch
        axis (the ranks of that axis hold other rows, so the weight must
        be whole there) become None."""
        return tuple(
            None if ((ax == "embed_fsdp" and self.ctx.gather_fsdp)
                     or any(a in self.batch_axes for a in entry_axes(e)))
            else e for e, ax in zip(spec, axes))

    def gather_leaf(self, t: torch.Tensor, spec: Spec,
                    axes: Sequence[Optional[str]]) -> torch.Tensor:
        """All-gather the dims ``gathered`` clears, differentiably: the
        backward sums a gradient over the gathered axes that split the
        batch (the data ranks' shares, exactly once) and takes this
        rank's block.  Each gather counts in ``PARAM_GATHERS``."""
        from repro_torch.models.collectives import all_gather
        after = self.gathered(spec, axes)
        for dim, (e, new) in enumerate(zip(spec, after)):
            if e is not None and new is None:
                g_axes = entry_axes(e)
                t = all_gather(t, dim, g_axes, self.mesh,
                               tuple(a for a in g_axes
                                     if a in self.batch_axes), param=True)
        return t
