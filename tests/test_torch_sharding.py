"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference's (``repro.models.sharding``), without ranks.

``ShardingCtx.spec_for`` and ``param_shardings`` read only the mesh's
axis sizes, so both packages run on a stand-in mesh that holds just
them.  For every rule table (``NAMED_RULES`` and ``DEFAULT_RULES``) and
the meshes (8,) ``data``, (2, 4) and (4, 2) ``("data", "model")``,
(1, 8) and (2, 2, 2) ``("pod", "data", "model")``: the spec of every
parameter of every arch of the registry (full and reduced widths) equal
to the reference's ``param_shardings`` entry for entry, and of seeded
random shapes over random logical axes (a sample by default, all under
``FUZZ_TORCH=1``).  Then the blocks ``shard_params`` cuts for each rank
of a mesh put back together give the full tree bit for bit, and the
port's parameter specs carry the reference's logical axes.
"""
import itertools
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.models import model as RM
from repro.models import sharding as RS
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models import sharding as SH
from repro_torch.models.model import param_specs
from repro_torch.models.params import ParamSpec

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
MESHES = {"8": ((8,), ("data",)),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TABLES = {"default": SH.DEFAULT_RULES,
          **{k: v for k, v in SH.NAMED_RULES.items() if v is not None}}
RANDOM_SHAPES = 200 if FUZZ else 24
LOGICAL = [None] + [k for k in SH.DEFAULT_RULES if k is not None]


class _Mesh:
    """Axis sizes, and the block indices of rank ``rank`` (row-major
    over the axes, as ``launch.mesh.Mesh`` lays the ranks out)."""

    def __init__(self, shape, axes, rank=0):
        self.axes = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.coords = dict(zip(axes, np.unravel_index(rank, shape)))

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def block_index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + int(self.coords[a])
        return i


class _SpecCtx(RS.ShardingCtx):
    """The reference's ctx with ``sharding_for`` giving the spec (its
    ``param_shardings`` wraps each spec in a ``NamedSharding``, which
    needs devices)."""

    def sharding_for(self, shape, axes):
        return self.spec_for(shape, axes)


def _ref_specs(tree, ctx):
    leaves = jax.tree.leaves(RS.param_shardings(tree, ctx),
                             is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [tuple(p) for p in leaves]


def _cfgs(arch):
    return ((ref_config(arch), get_config(arch)),
            (ref_reduced(arch), get_reduced(arch)))


def _random_specs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(RANDOM_SHAPES):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice(
            [1, 2, 3, 4, 6, 8, 12, 16, 24, 64, 96], nd))
        axes = tuple(LOGICAL[int(i)] for i in rng.integers(0, len(LOGICAL),
                                                            nd))
        out.append((shape, axes))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("table", sorted(TABLES))
def test_spec_for_and_param_shardings_equal_reference(table, mesh):
    shape, axes = MESHES[mesh]
    fake = _Mesh(shape, axes)
    rules = TABLES[table]
    ref_rules = RS.DEFAULT_RULES if table == "default" else \
        RS.NAMED_RULES[table]
    assert ref_rules == rules
    ctx = SH.ShardingCtx(fake, rules)
    rctx = _SpecCtx(mesh=fake, rules=ref_rules)
    for arch in ARCH_IDS:
        for rcfg, cfg in _cfgs(arch):
            want = _ref_specs(RM.param_specs(rcfg), rctx)
            got = SH.spec_leaves(SH.param_shardings(param_specs(cfg),
                                                       ctx))
            assert got == want, (arch, table, mesh)
    seed = sorted(TABLES).index(table) * 10 + sorted(MESHES).index(mesh)
    for s, a in _random_specs(seed):
        assert ctx.spec_for(s, a) == tuple(rctx.spec_for(s, a)), (s, a)
        assert SH.spec_for_shape(fake.shape, rules, s, a) == \
            tuple(rctx.spec_for(s, a))


def test_rule_tables_are_the_reference_s():
    assert set(SH.NAMED_RULES) == set(RS.NAMED_RULES)
    for k, v in SH.NAMED_RULES.items():
        assert v == RS.NAMED_RULES[k], k
    assert SH.DEFAULT_RULES == RS.DEFAULT_RULES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_carry_the_reference_s_axes(arch):
    def flat(tree):
        return jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes"))
    want = flat(RM.param_specs(ref_reduced(arch)))
    got = SH.spec_leaves(param_specs(get_reduced(arch)))
    assert [(tuple(s.shape), tuple(s.axes)) for s in got] == \
        [(tuple(s.shape), tuple(s.axes)) for s in want]


def _reassemble(blocks, spec, mesh_shape, axes):
    """The full tensor from every rank's block, placed by its block
    indices."""
    n_ranks = int(np.prod(mesh_shape))
    first = blocks[0]
    full_shape = [n * (int(np.prod([dict(zip(axes, mesh_shape))[a]
                                    for a in SH.entry_axes(e)])) if e else 1)
                  for n, e in zip(first.shape, spec)]
    out = torch.full(full_shape, float("nan"))
    for r in range(n_ranks):
        m = _Mesh(mesh_shape, axes, r)
        idx = tuple(slice(m.block_index(SH.entry_axes(e)) * n,
                          (m.block_index(SH.entry_axes(e)) + 1) * n)
                    if e else slice(None)
                    for n, e in zip(first.shape, spec))
        out[idx] = blocks[r]
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "gemma2-27b",
                                  "granite-20b", "qwen2-vl-72b"])
def test_shard_params_blocks_put_back_give_the_tree(arch, mesh):
    shape, axes = MESHES[mesh]
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(5)
    full = [torch.randn(s.shape, generator=gen)
            for s in SH.spec_leaves(param_specs(cfg))]
    for table in ("default", "small", "fsdp_pod"):
        ctx0 = SH.ShardingCtx(_Mesh(shape, axes), TABLES[table])
        specs = SH.spec_leaves(SH.param_shardings(param_specs(cfg), ctx0))
        per_rank = [SH.shard_params(
            full, SH.ShardingCtx(_Mesh(shape, axes, r), TABLES[table]),
            specs) for r in range(int(np.prod(shape)))]
        for i, spec in enumerate(specs):
            blocks = [pr[i] for pr in per_rank]
            assert all(b.is_contiguous() for b in blocks)
            assert blocks[0].shape == ctx0.block_shape(full[i].shape, spec)
            torch.testing.assert_close(
                _reassemble(blocks, spec, shape, axes), full[i], rtol=0,
                atol=0)


def test_constrain_checks_the_local_block():
    ctx = SH.ShardingCtx(_Mesh((2, 4), ("data", "model")), SH.DEFAULT_RULES)
    x = torch.zeros(4, 32, 4, 16)
    assert SH.constrain(x, (8, 32, 4, 16), ("batch", None, None, None),
                        None) is x
    assert SH.constrain(x, (8, 32, 4, 16), ("batch", None, None, None),
                        ctx) is x
    # heads split over model: a (4, 32, 1, 16) block
    with pytest.raises(ValueError, match="block"):
        SH.constrain(x, (8, 32, 4, 16), ("batch", None, "heads", None), ctx)


def test_rank_layout_reads_the_batch_split():
    mesh = _Mesh((2, 2, 2), ("pod", "data", "model"), rank=5)
    ctx = SH.ShardingCtx(mesh, SH.DEFAULT_RULES)
    lay = SH.RankLayout.for_batch(ctx, 8)
    assert lay.batch_axes == ("pod", "data") and lay.n_blocks == 4
    rows = torch.arange(8)
    assert lay.rows(rows).tolist() == [4, 5]          # pod 1, data 0
    # batch 2: the longest prefix of (pod, data) that divides it
    assert SH.RankLayout.for_batch(ctx, 2).batch_axes == ("pod",)
    assert SH.RankLayout.for_batch(ctx, 1).batch_axes == ()
    small = SH.RankLayout.for_batch(SH.ShardingCtx(mesh,
                                                   SH.SMALL_MODEL_RULES), 8)
    assert small.batch_axes == ("pod", "data", "model")
    # lm_head (d, V): the FSDP dim gathered; the vocab stays split over
    # model under the default rules, and is gathered where the batch is
    # split over model too
    spec = ctx.spec_for((64, 256), ("embed_fsdp", "vocab"))
    assert spec == ("data", "model")
    assert lay.gathered(spec, ("embed_fsdp", "vocab")) == (None, "model")
    assert lay.tp_axes("model") == ("model",)
    assert small.gathered(spec, ("embed_fsdp", "vocab")) == (None, None)


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4, 6, 8])
def test_axis_sizes_and_block_shapes(n_ranks):
    for shape in itertools.product(range(1, 5), repeat=2):
        if int(np.prod(shape)) != n_ranks:
            continue
        ctx = SH.ShardingCtx(_Mesh(shape, ("data", "model")),
                             SH.DEFAULT_RULES)
        assert ctx.axis_size(("data", "model")) == n_ranks
        assert ctx.axis_size("model") == shape[1]
        spec = ctx.spec_for((12, 8, 16), ("embed_fsdp", "heads", None))
        blk = ctx.block_shape((12, 8, 16), spec)
        assert np.prod(blk) * np.prod([
            ctx.axis_size(SH.entry_axes(e)) for e in spec]) == 12 * 8 * 16


def test_param_spec_axes_must_match_the_shape():
    with pytest.raises(ValueError, match="axes"):
        ParamSpec((2, 3), "normal", 1.0, ("embed",))
