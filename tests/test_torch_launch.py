"""Launch analysis of the port (``repro_torch.launch``: ``specs``,
``op_analysis``, ``dryrun``, ``roofline``) against the reference's
(``repro.launch``), on the CPU.

* ``model_flops`` and ``rules_for`` equal to the reference's for every
  (arch, shape) cell of ``all_cells()``, and ``batch_specs``' shapes and
  specs on both production meshes;
* the one-process step of reduced internlm2, mamba2 and moonshot at B 2,
  S 128, remat None and "full", counted on ``meta``: within 5% of XLA's
  ``cost_analysis()["flops"]`` for the reference's step compiled on a
  (1, 1) mesh, and equal to the count of the same step run on the CPU
  with real tensors;
* on a (2, 2) mesh, a reduced ``DEFAULT_RULES`` train cell and a
  ``SMALL_SERVE_RULES`` decode cell: every ``AbstractMesh`` rank's flops
  and collective counters equal those of the same rank of a real
  4-rank gloo run on the CPU;
* ``run_cell`` on the committed ``train_4k`` 16x16 cells: ``ok``, the
  reference's ``model_flops_global``, rank 0's parameter and
  optimiser-state bytes equal to the artifacts' ``aliased`` bytes; and
  ``roofline.to_markdown`` on their records;
* mamba2's bf16 decode cells count, and its bf16 decode step matches the
  reference's.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.compat import make_mesh
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.configs import get_shape as ref_shape
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import specs as RSP
from repro.models import sharding as RS
from repro.train.train_step import TrainHParams as RefHP
from repro_torch.configs import all_cells, get_config, get_reduced, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import sharding as SH
from repro_torch.train.train_step import TrainHParams

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a, shapes in ref_all_cells().items() for s in shapes]
AXES = ("data", "model")
# the committed dry-run cells: the reference's model FLOPs and its
# parameter plus optimiser-state bytes a device (``aliased``)
TRAIN_CELLS = {"internlm2-1.8b": (1.3151889940021248e16, 1_070_581_760),
               "mamba2-2.7b": (1.7812974206976e16, 2_997_184_000)}
# B 2, S 128: the meta count against XLA's
XLA_RTOL = 0.05
# (tag, arch, shape, rules) on a (2, 2) mesh, abstract against gloo
RANK_CELLS = (("train", "moonshot-v1-16b-a3b",
               ShapeConfig("t", "train", 64, 4), "DEFAULT_RULES"),
              ("decode", "internlm2-1.8b",
               ShapeConfig("d", "decode", 64, 4), "SMALL_SERVE_RULES"))


def test_cells_are_the_references():
    assert {a: tuple(s) for a, s in all_cells().items()} == {
        a: tuple(s) for a, s in ref_all_cells().items()}
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_reference(arch, shape):
    got = SP.model_flops(get_config(arch), get_shape(shape))
    want = RSP.model_flops(ref_config(arch), ref_shape(shape))
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_rules_for_equal_reference(arch, shape):
    got = SP.rules_for(get_config(arch), get_shape(shape))
    want = RSP.rules_for(ref_config(arch), ref_shape(shape))
    assert got == want
    # and an override passes through
    assert SP.rules_for(get_config(arch), get_shape(shape),
                        SH.DECODE_2D_RULES) is SH.DECODE_2D_RULES


class _Mesh:
    def __init__(self, shape, axes):
        self.axes = tuple(axes)
        self.shape = dict(zip(axes, shape))


class _SpecCtx(RS.ShardingCtx):
    """The reference's ctx with ``sharding_for`` giving the spec (a
    ``NamedSharding`` needs devices)."""

    def sharding_for(self, shape, axes):
        return self.spec_for(shape, axes)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_batch_specs_equal_reference(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    stand_in = _Mesh(tuple(mesh.shape.values()), mesh.axes)
    for arch, shape in CELLS:
        cfg, sh = get_config(arch), get_shape(shape)
        ctx = SP.make_ctx(mesh, cfg, sh)
        rctx = _SpecCtx(mesh=stand_in,
                        rules=RSP.rules_for(ref_config(arch),
                                            ref_shape(shape)))
        specs, shards = SP.batch_specs(cfg, sh, ctx)
        rspecs, rshards = RSP.batch_specs(ref_config(arch), ref_shape(shape),
                                          rctx)
        assert sorted(specs) == sorted(rspecs), (arch, shape)
        for k in specs:
            assert specs[k].shape == tuple(rspecs[k].shape), (arch, shape, k)
            assert str(specs[k].dtype).split(".")[-1] == str(
                rspecs[k].dtype), (arch, shape, k)
            assert shards[k] == tuple(rshards[k]), (arch, shape, k)
            assert isinstance(rshards[k], PartitionSpec)


def _count(arch, remat, device):
    mem, st, _ = dryrun.count_step(
        get_reduced(arch), ShapeConfig("t", "train", 128, 2),
        AbstractMesh((1, 1), AXES), hp=TrainHParams(remat=remat,
                                                    ce_chunk=1024),
        param_dtype=torch.float32, device=device)
    return st


@pytest.mark.parametrize("remat", [None, "full"], ids=["none", "full"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b",
                                  "moonshot-v1-16b-a3b"])
def test_meta_count_against_xla_and_cpu(arch, remat):
    fn, args, shards, _ = RSP.lower_target(
        ref_reduced(arch), RefShape("t", "train", 128, 2),
        make_mesh((1, 1), AXES), hp=RefHP(remat=remat, ce_chunk=1024),
        param_dtype=jnp.float32)
    mesh = make_mesh((1, 1), AXES)
    with mesh:
        # LLVM's optimisation level 0: the HLO XLA counts is the same,
        # compiled faster
        ca = jax.jit(fn, in_shardings=shards).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})\
            .cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    meta = _count(arch, remat, "meta")
    assert abs(meta.flops / ca["flops"] - 1) <= XLA_RTOL, (meta.flops,
                                                           ca["flops"])
    cpu = _count(arch, remat, "cpu")
    assert (meta.flops, meta.dot_count, meta.bytes_dot) == (
        cpu.flops, cpu.dot_count, cpu.bytes_dot)


def _rank_count(tag, arch, shape, rules, mesh, device):
    _, st, _ = dryrun.count_step(
        get_reduced(arch), shape, mesh, param_dtype=torch.float32,
        rules_override=getattr(SH, rules), device=device)
    from repro_torch.models import collectives as C
    return {"flops": st.flops, "dot_count": st.dot_count,
            "bytes": dict(C.COLLECTIVE_BYTES), "msgs": dict(C.COLLECTIVE_MSGS),
            "param_gathers": dict(C.PARAM_GATHERS),
            "collective_bytes": dict(st.collective_bytes)}


def count_rank(cells):
    """One rank of a real (2, 2) gloo mesh: each cell's step on zero-filled
    CPU tensors, counted."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2, 2), AXES)
    return {tag: _rank_count(tag, arch, shape, rules, mesh, "cpu")
            for tag, arch, shape, rules in cells}


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    return spawn_ranks(4, "test_torch_launch:count_rank", (RANK_CELLS,),
                       backend="gloo", init_method=f"file://{tmp / 'store'}",
                       timeout_s=300)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("cell", RANK_CELLS, ids=[c[0] for c in RANK_CELLS])
def test_abstract_rank_counts_equal_gloo(gloo_counts, cell, rank):
    tag, arch, shape, rules = cell
    got = _rank_count(tag, arch, shape, rules,
                      AbstractMesh((2, 2), AXES, rank), "meta")
    assert got == gloo_counts[rank][tag]
    assert got["msgs"], "the cell runs no collective"


@pytest.fixture(scope="module")
def train_records(tmp_path_factory):
    return {a: dryrun.run_cell(a, "train_4k", False) for a in TRAIN_CELLS}


@pytest.mark.parametrize("arch", sorted(TRAIN_CELLS))
def test_run_cell_train_4k(train_records, arch):
    rec = train_records[arch]
    assert rec["ok"], rec.get("traceback")
    flops, state = TRAIN_CELLS[arch]
    art = json.loads((ROOT / "artifacts" / "dryrun" /
                      f"{arch}__train_4k__16x16__baseline.json").read_text())
    assert rec["model_flops_global"] == flops == art["model_flops_global"]
    mem = rec["memory_per_device"]
    assert mem["params"] + mem["opt_state"] == state == art[
        "memory_per_device"]["aliased"]
    assert mem["arguments"] == state + mem["batch"]
    assert mem["total_live"] == mem["arguments"] + mem["peak_created"]
    assert (rec["mesh"], rec["devices"]) == ("16x16", 256)
    roof = rec["roofline"]
    assert roof["bound_s"] == max(roof["t_compute_s"], roof["t_memory_s"],
                                  roof["t_collective_s"]) > 0
    assert rec["per_device"]["flops"] > 0 and rec["per_device"][
        "collective_count"]["all-gather"] > 0


def test_roofline_markdown(train_records):
    md = roofline.to_markdown([train_records[a] for a in sorted(TRAIN_CELLS)],
                              title="t")
    lines = md.splitlines()
    assert lines[0] == "### t" and len(lines) == 4 + len(TRAIN_CELLS)
    for a, line in zip(sorted(TRAIN_CELLS), lines[4:]):
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert cells[:3] == [a, "train_4k", "16x16"]
        assert cells[6] == train_records[a]["roofline"]["dominant"]
        assert "(>" not in cells[9]
        assert cells[10]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_ssm_decode_cells_count(shape):
    """mamba2-2.7b's decode cells in bf16: the dry run found the port's
    SSM decode refusing a bf16 B/C against the float32 state (the
    reference's ``jnp.einsum`` promotes)."""
    rec = dryrun.run_cell("mamba2-2.7b", shape, False)
    assert rec["ok"], rec.get("traceback")
    assert rec["memory_per_device"]["caches"] > 0


def test_bf16_ssm_decode_matches_reference():
    """Reduced mamba2 with bf16 parameters (the reference's draw): a
    prefill of 8 tokens then one decode step, the port's logits within
    two bf16 ulps of the largest of the reference's."""
    from repro.models import model as RM
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    cfg_r, cfg = ref_reduced("mamba2-2.7b"), get_reduced("mamba2-2.7b")
    p = RM.init_model_params(cfg_r, jax.random.PRNGKey(0), jnp.bfloat16)
    flat = {jax.tree_util.keystr(k): np.array(v.astype(jnp.float32))
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    spec = M.param_specs(cfg)
    tp = tree_unflatten(spec, [torch.from_numpy(flat[k]).to(torch.bfloat16)
                               for k, _ in tree_flatten(spec)])
    B, S = 2, 8
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    prefill = jax.jit(lambda p, b: RM.prefill(cfg_r, p, b, 16)[1])
    rc = prefill(p, {"tokens": jnp.asarray(toks[:, :S])})
    want, _ = jax.jit(lambda p, b, c: RM.decode_step(cfg_r, p, b, c, S))(
        p, {"tokens": jnp.asarray(toks[:, S:])}, rc)
    _, tc, _ = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                         16)
    got, _ = M.decode_step(cfg, tp, {"tokens": torch.from_numpy(toks[:, S:])},
                           tc, S)
    want = np.asarray(want.astype(jnp.float32))
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= 2 * ulp
