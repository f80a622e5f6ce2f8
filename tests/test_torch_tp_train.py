"""The port's sharded training (``make_train_step(cfg, hp, ctx)``: tensor,
expert and FSDP parallelism over gloo ranks; ``make_train_step_regc``
with an ``inner_ctx``; ``Trainer(ctx=)``) on the CPU, against the
reference's GSPMD step.

One JAX subprocess with 8 host devices (as ``tests/test_variants.py``
runs ``EP_TRAIN_SCRIPT``) writes, for each case, the parameters
(``PRNGKey(0)``), the batch (8 x 32 tokens and targets from
``PRNGKey(1)``; N(0, 1) embeddings and (3, B, S) M-RoPE positions with
distinct t/h/w axes and a row offset where the config takes them) and
the reference's jitted ``make_train_step(cfg, hp, ctx)`` step (loss,
grad norm, updated parameters), its gradients (the step's
``value_and_grad``, microbatches as the step sums them) and the loss's
``aux_loss`` / ``expert_load``.  The cases: mesh (2, 4) ``("data",
"model")`` under ``DEFAULT_RULES`` for grok-1-314b and
moonshot-v1-16b-a3b with ``moe_impl`` dense and ep, internlm2-1.8b (kv
heads fall back to replication on 4 model ranks), granite-20b (MQA),
gemma2-27b (tied vocab-parallel embedding, softcaps, a local window) and
qwen2-vl-72b (embeds, M-RoPE positions split on dim 1); a (2, 2, 2)
``("pod", "data", "model")`` mesh under ``FSDP_POD_RULES`` (moonshot,
ep); ``SMALL_MODEL_RULES`` (internlm2; the batch split over the model
axis too); and ``n_micro=2`` (grok, dense).  The RegC path with an
``inner_ctx`` whose rules name no dp axis (``batch``/``embed_fsdp``
None) runs internlm2 and grok; the reference's two refusals are
checked to raise in the port too.

Eight spawned gloo ranks run the port from the carried parameters, each
on its blocks.  Checked: loss within 1e-5 relative; gathered gradients
within 1e-4 of each leaf's largest |value|; updated parameters at the
reference's own rtol 5e-3 / atol 5e-5; ``aux_loss`` / ``expert_load``
within 1e-5; every block held by several ranks bit-equal (a digest of
every local leaf of the parameters, moments and gradients after the
step); and the same step against the port's one-process step with
``moe_block`` at the ctx's group count (the EP cases with each group's
own aux loss averaged), at the same tolerances.

Two ranks run ``tests/test_trainer.py``'s trainer cases under a ctx
(mesh (1, 2), ``DEFAULT_RULES``): runs and checkpoints, survives an
injected failure, a restart is an exact replay; the checkpoint, read
back by the one-process port, equals the gathered tree.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, restore_extra
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import collectives as C
from repro_torch.models import sharding as SH
from repro_torch.models.model import param_specs
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train import train_step as T
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]

WORLD = 8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 5e-5
STAT_TOL = 1e-5
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RULES = {"default": "DEFAULT_RULES", "fsdp_pod": "FSDP_POD_RULES",
         "small": "SMALL_MODEL_RULES"}
# (tag, arch, mesh, rules, moe_impl, n_micro)
CASES = (
    ("grok_dense", "grok-1-314b", "2x4", "default", "dense", 1),
    ("grok_ep", "grok-1-314b", "2x4", "default", "ep", 1),
    ("moonshot_dense", "moonshot-v1-16b-a3b", "2x4", "default", "dense", 1),
    ("moonshot_ep", "moonshot-v1-16b-a3b", "2x4", "default", "ep", 1),
    ("internlm2", "internlm2-1.8b", "2x4", "default", "dense", 1),
    ("granite", "granite-20b", "2x4", "default", "dense", 1),
    ("gemma2", "gemma2-27b", "2x4", "default", "dense", 1),
    ("qwen2_vl", "qwen2-vl-72b", "2x4", "default", "dense", 1),
    ("moonshot_fsdp_pod", "moonshot-v1-16b-a3b", "2x2x2", "fsdp_pod", "ep",
     1),
    ("internlm2_small", "internlm2-1.8b", "2x4", "small", "dense", 1),
    ("grok_micro", "grok-1-314b", "2x4", "default", "dense", 2),
)
# cases the ranks also run under remat "full" and "dots"
REMAT_CASES = ("moonshot_ep", "internlm2_small")
# the RegC path with an inner ctx: (tag, arch)
REGC_CASES = (("regc_internlm2", "internlm2-1.8b"),
              ("regc_grok", "grok-1-314b"))
B, S = 8, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_reduced
from repro.models import model as M
from repro.models import sharding as SH
from jax import lax
from repro.optim.adamw import adamw_update, init_opt_state, warmup_cosine
from repro.train.train_step import (TrainHParams, _constrain_batch,
                                    _microbatch, make_train_step,
                                    make_train_step_regc)
from repro.utils.tree import tree_add, tree_scale, tree_zeros_like

out_path, spec = sys.argv[1], eval(sys.argv[2])
B, S = spec["B"], spec["S"]
res = {}
meshes = {k: make_mesh(shape, axes) for k, (shape, axes) in
          spec["meshes"].items()}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


def inputs(cfg):
    params = M.init_model_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    batch = {"targets": jax.random.randint(ks[1], (B, S), 0,
                                           cfg.vocab_size)}
    if cfg.input_mode == "embeds":
        batch["embeds"] = jax.random.normal(ks[2], (B, S, cfg.d_model))
    else:
        batch["tokens"] = jax.random.randint(ks[0], (B, S), 0,
                                             cfg.vocab_size)
    if cfg.mrope:
        i = np.arange(S - 4)
        grid = np.stack([np.r_[np.arange(4), np.full(i.size, 4)],
                         np.r_[np.arange(4), 4 + i // 8],
                         np.r_[np.arange(4), 4 + i % 8]])
        pos = grid[:, None, :] + np.arange(B)[None, :, None]
        batch["positions"] = jnp.asarray(pos.astype(np.int32))
    return params, batch


def step_and_grads(cfg, hp, ctx):
    # make_train_step's body, its gradients and metrics returned as well:
    # one compile a case
    sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)

    def loss_f(p, b):
        return M.loss_fn(cfg, p, b, ctx, attn_impl=hp.attn_impl,
                         remat=hp.remat, ce_chunk=hp.ce_chunk,
                         remat_segment=hp.remat_segment)

    def fn(params, opt, batch, step):
        batch = _constrain_batch(cfg, batch, ctx)
        if hp.n_micro == 1:
            (loss, mts), grads = jax.value_and_grad(
                loss_f, has_aux=True)(params, batch)
        else:
            mbatch = _microbatch(batch, hp.n_micro, lambda k: 0)

            def micro(carry, mb):
                g_acc, l_acc = carry
                mb = _constrain_batch(cfg, mb, ctx)
                (l, _), g = jax.value_and_grad(loss_f, has_aux=True)(
                    params, mb)
                return (tree_add(g_acc, g), l_acc + l), None

            g0 = tree_zeros_like(params, jnp.float32)
            (grads, loss), _ = lax.scan(micro, (g0, jnp.zeros(())), mbatch)
            grads = tree_scale(grads, 1.0 / hp.n_micro)
            loss = loss / hp.n_micro
            mts = {}
        new_params, _, gnorm = adamw_update(params, grads, opt, step,
                                            sched(step), hp.adamw)
        return new_params, loss, gnorm, grads, mts
    return jax.jit(fn)


step0 = jnp.zeros((), jnp.int32)
for tag, arch, mesh_key, rules, impl, n_micro in spec["cases"]:
    cfg = get_reduced(arch)
    params, batch = inputs(cfg)
    ctx = SH.ShardingCtx(mesh=meshes[mesh_key], rules=getattr(SH, rules),
                         moe_impl=impl)
    hp = TrainHParams(remat=None, ce_chunk=32, n_micro=n_micro)
    put(f"{tag}/in/params", params)
    res.update({f"{tag}/in/batch/{k}": np.asarray(v)
                for k, v in batch.items()})
    opt = init_opt_state(params)
    p2, loss, gnorm, g, mts = step_and_grads(cfg, hp, ctx)(
        params, opt, batch, step0)
    if tag == spec["check_step"]:
        # the copied body against the reference's own step
        q2, _, m = jax.jit(make_train_step(cfg, hp, ctx))(
            params, opt, batch, step0)
        assert float(m["loss"]) == float(loss), (m["loss"], loss)
        for a, b in zip(jax.tree.leaves(q2), jax.tree.leaves(p2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
    put(f"{tag}/params", p2)
    res[f"{tag}/loss"] = np.asarray(loss)
    res[f"{tag}/grad_norm"] = np.asarray(gnorm)
    put(f"{tag}/grads", g)
    for k in ("aux_loss", "expert_load"):
        if k in mts:
            res[f"{tag}/{k}"] = np.asarray(mts[k])

# the RegC path with an inner ctx whose rules name no dp axis
inner_rules = dict(SH.DEFAULT_RULES, batch=None, embed_fsdp=None)
for tag, arch in spec["regc"]:
    cfg = get_reduced(arch)
    params, batch = inputs(cfg)
    put(f"{tag}/in/params", params)
    res.update({f"{tag}/in/batch/{k}": np.asarray(v)
                for k, v in batch.items()})
    ctx = SH.ShardingCtx(mesh=meshes["2x4"], rules=inner_rules)
    hp = TrainHParams(remat=None, ce_chunk=32)
    step = jax.jit(make_train_step_regc(cfg, hp, meshes["2x4"],
                                        dp_axes=("data",), inner_ctx=ctx))
    p2, _, m = step(params, init_opt_state(params), batch, step0)
    put(f"{tag}/params", p2)
    res[f"{tag}/loss"] = np.asarray(m["loss"])
    res[f"{tag}/grad_norm"] = np.asarray(m["grad_norm"])
np.savez(out_path, **res)
print("REF_OK")
"""


def run_reference(out: Path, spec) -> dict:
    """REF_SCRIPT on 8 host devices.  LLVM's optimisation level 0 makes
    the thirteen compiles about a third faster; the programs XLA
    partitions and runs are the same."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                           repr(spec)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _tree(cfg, arrays, prefix):
    spec = param_specs(cfg)
    return tree_unflatten(spec, [torch.from_numpy(np.array(arrays[prefix + k]))
                                 for k, _ in tree_flatten(spec)])


def _batch(arrays, tag):
    pre = f"{tag}/in/batch/"
    return {k[len(pre):]: torch.from_numpy(np.array(v))
            for k, v in arrays.items() if k.startswith(pre)}


def _flat(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree_flatten(tree)}


def _digests(tree, specs, mesh):
    """(leaf path, this rank's block of it) -> sha256 of the leaf's
    bytes: ranks holding the same block must agree."""
    out = {}
    for (k, v), spec in zip(tree_flatten(tree), SH.spec_leaves(specs)):
        block = tuple(mesh.block_index(SH.entry_axes(e)) if e else 0
                      for e in spec)
        out[(k, block)] = hashlib.sha256(
            v.detach().contiguous().numpy().tobytes()).hexdigest()
    return out


def _ctx(mesh, rules, impl):
    return SH.ShardingCtx(mesh, getattr(SH, RULES[rules]), moe_impl=impl)


def step_rank(ref_path: str, cases, regc_cases):
    """One rank: every case's sharded step from the reference's state."""
    import torch.distributed as dist
    rank = dist.get_rank()
    with np.load(ref_path) as z:
        ref = dict(z)
    meshes = {k: make_host_mesh(*v) for k, v in MESHES.items()}
    out = {}
    for tag, arch, mesh_key, rules, impl, n_micro in cases:
        cfg = get_reduced(arch)
        mesh = meshes[mesh_key]
        ctx = _ctx(mesh, rules, impl)
        specs = SH.param_shardings(param_specs(cfg), ctx)
        params = _tree(cfg, ref, f"{tag}/in/params")
        batch = _batch(ref, tag)
        hp = T.TrainHParams(remat=None, ce_chunk=32, n_micro=n_micro)
        lp, lo = T.shard_state(cfg, ctx, params, init_opt_state(params))
        back = T.gather_state(cfg, ctx, lp)
        roundtrip = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(params)))
        C.reset_collectives()
        p2, o2, m, g = T.make_train_step(cfg, hp, ctx)(lp, lo, batch, 0,
                                                       with_grads=True)
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "msgs": sum(C.COLLECTIVE_MSGS.values()),
               "roundtrip": roundtrip,
               "digests": {**_digests(p2, specs, mesh),
                           **{("m",) + k: v for k, v in
                              _digests(o2["m"], specs, mesh).items()},
                           **{("g",) + k: v for k, v in
                              _digests(g, specs, mesh).items()}}}
        if n_micro == 1:
            _, mts = T.eval_loss(cfg, hp, lp, batch, ctx)
            row["stats"] = {k: mts[k].numpy() for k in
                            ("aux_loss", "expert_load") if k in mts}
        full_g = T.gather_state(cfg, ctx, g)
        full_p = T.gather_state(cfg, ctx, p2)
        if rank == 0:
            row.update(grads=_flat(full_g), params=_flat(full_p))
        if tag in REMAT_CASES:
            # the gathers and sums inside a checkpointed super-block run
            # again in the backward's recompute, in the same order on
            # every rank
            for remat in ("full", "dots"):
                hp_r = T.TrainHParams(remat=remat, ce_chunk=32,
                                      n_micro=n_micro)
                r2, _, mr, gr = T.make_train_step(cfg, hp_r, ctx)(
                    lp, lo, batch, 0, with_grads=True)
                row[f"remat_{remat}"] = {
                    "loss": float(mr["loss"]), "grad_err": max(
                        float((a - b).abs().max()) for a, b in zip(
                            tree_leaves(gr), tree_leaves(g)))}
        out[tag] = row
    inner = SH.ShardingCtx(meshes["2x4"], dict(SH.DEFAULT_RULES, batch=None,
                                               embed_fsdp=None))
    for tag, arch in regc_cases:
        cfg = get_reduced(arch)
        params = _tree(cfg, ref, f"{tag}/in/params")
        hp = T.TrainHParams(remat=None, ce_chunk=32)
        lp, lo = T.shard_state(cfg, inner, params, init_opt_state(params))
        step = T.make_train_step_regc(cfg, hp, meshes["2x4"],
                                      dp_axes=("data",), inner_ctx=inner)
        p2, o2, m = step(lp, lo, _batch(ref, tag), 0)
        specs = SH.param_shardings(param_specs(cfg), inner)
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "digests": _digests(p2, specs, meshes["2x4"])}
        full_p = T.gather_state(cfg, inner, p2)
        if rank == 0:
            row["params"] = _flat(full_p)
        out[tag] = row
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    ref = run_reference(tmp / "ref.npz", {
        "B": B, "S": S, "meshes": MESHES,
        "cases": [(t, a, mk, RULES[r], i, n) for t, a, mk, r, i, n in CASES],
        "regc": list(REGC_CASES), "check_step": "grok_micro"})
    got = spawn_ranks(WORLD, "test_torch_tp_train:step_rank",
                      (str(tmp / "ref.npz"), CASES, REGC_CASES),
                      backend="gloo", init_method=f"file://{tmp / 'store'}",
                      timeout_s=300)
    return ref, got


def _leaf_close(a, b, tol):
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a - b).max()) <= tol * scale


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_sharded_step_matches_reference(steps, tag):
    ref, got = steps
    row = got[0][tag]
    np.testing.assert_allclose(row["loss"], ref[f"{tag}/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(row["grad_norm"], ref[f"{tag}/grad_norm"],
                               rtol=GRAD_TOL)
    for k, g in row["grads"].items():
        assert _leaf_close(g, ref[f"{tag}/grads{k}"], GRAD_TOL), k
    for k, p in row["params"].items():
        np.testing.assert_allclose(p, ref[f"{tag}/params{k}"],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{tag} {k}")


@pytest.mark.parametrize("tag", [c[0] for c in CASES if c[5] == 1])
def test_sharded_moe_stats_match_reference(steps, tag):
    ref, got = steps
    stats = got[0][tag]["stats"]
    assert set(stats) == {k for k in ("aux_loss", "expert_load")
                          if f"{tag}/{k}" in ref}
    for k, v in stats.items():
        np.testing.assert_allclose(v, ref[f"{tag}/{k}"], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("tag", [c[0] for c in CASES]
                         + [c[0] for c in REGC_CASES])
def test_replicas_stay_bit_equal(steps, tag):
    """Every block held by several ranks has the same bits on each, and
    every rank reports the same loss and grad norm."""
    _, got = steps
    seen = {}
    for g in got:
        for key, digest in g[tag]["digests"].items():
            assert seen.setdefault(key, digest) == digest, (tag, key)
    assert len({(g[tag]["loss"], g[tag]["grad_norm"]) for g in got}) == 1


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_sharded_step_matches_one_process_step(steps, tag):
    """The ranks' step against the port's one-process step on the global
    batch, with moe_block at the ctx's dispatch groups (each group's own
    aux loss averaged, as the expert-parallel block defines it)."""
    ref, got = steps
    _, arch, mesh_key, rules, impl, n_micro = next(c for c in CASES
                                                   if c[0] == tag)
    cfg = get_reduced(arch)
    shape = dict(zip(MESHES[mesh_key][1], MESHES[mesh_key][0]))
    rules_t = getattr(SH, RULES[rules])
    ep = (impl == "ep" and cfg.moe is not None
          and cfg.moe.n_experts % shape["model"] == 0)
    axes = tuple(a for a in rules_t["batch"] if a in shape)
    if ep:
        axes = tuple(a for a in axes if a != "model")
    groups = int(np.prod([shape[a] for a in axes]))
    params = _tree(cfg, ref, f"{tag}/in/params")
    hp = T.TrainHParams(remat=None, ce_chunk=32, n_micro=n_micro)
    p1, _, m1, g1 = T.make_train_step(
        cfg, hp, moe_groups=groups, moe_group_aux=ep)(
        params, init_opt_state(params), _batch(ref, tag), 0,
        with_grads=True)
    row = got[0][tag]
    np.testing.assert_allclose(row["loss"], float(m1["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(row["grad_norm"], float(m1["grad_norm"]),
                               rtol=GRAD_TOL)
    for k, g in _flat(g1).items():
        assert _leaf_close(row["grads"][k], g, GRAD_TOL), k
    for k, p in _flat(p1).items():
        np.testing.assert_allclose(row["params"][k], p, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("tag", [c[0] for c in REGC_CASES])
def test_regc_inner_ctx_matches_reference(steps, tag):
    ref, got = steps
    row = got[0][tag]
    np.testing.assert_allclose(row["loss"], ref[f"{tag}/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(row["grad_norm"], ref[f"{tag}/grad_norm"],
                               rtol=GRAD_TOL)
    for k, p in row["params"].items():
        np.testing.assert_allclose(p, ref[f"{tag}/params{k}"],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{tag} {k}")


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("tag", REMAT_CASES)
def test_remat_changes_no_value(steps, tag, remat):
    """Remat changes memory, never values: the same loss, and gradients
    within float32 reordering (1e-6 absolute), on every rank."""
    _, got = steps
    for g in got:
        row = g[tag]
        assert row[f"remat_{remat}"]["loss"] == row["loss"]
        assert row[f"remat_{remat}"]["grad_err"] <= 1e-6


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_gather_params_inverts_shard_params(steps, tag):
    """Every rank's blocks, gathered, give the carried tree bit for bit."""
    _, got = steps
    assert all(g[tag]["roundtrip"] for g in got)


def test_collectives_run_where_the_layout_says(steps):
    """The tensor-parallel cases move activations every layer; the small
    rules' case (batch over every axis, no tensor parallelism) only
    gathers weights and sums gradients."""
    _, got = steps
    assert all(got[0][t]["msgs"] > 0 for t, *_ in CASES)
    assert got[0]["internlm2"]["msgs"] > got[0]["internlm2_small"]["msgs"]


# ---------------------------------------------------------------------------
# refusals, in one process
# ---------------------------------------------------------------------------


class _Shape:
    """A mesh's axis sizes alone (enough for the checks that raise
    before any collective)."""

    def __init__(self, **shape):
        self.shape = shape


def test_sharded_refusals_name_13f():
    """The training refusals that stood after serving under a ctx was
    ported (ROADMAP 13f) are gone with item 13g: the serving tables' axes
    in a training step, ``gather_fsdp=False``, ``adamw8bit`` and SSM
    layers under a ctx build a step; an unknown ``moe_impl`` is still a
    ``ValueError``, the one refusal of the reference's."""
    cfg = get_reduced("internlm2-1.8b")
    mesh = _Shape(data=2, model=4)
    hp = T.TrainHParams()
    for rules in (SH.SERVE_RULES, SH.SMALL_SERVE_RULES, SH.DECODE_2D_RULES,
                  SH.LONG_CONTEXT_RULES, SH.LONG_2D_RULES,
                  SH.TRAIN_SP_RULES):
        assert callable(T.make_train_step(cfg, hp, SH.ShardingCtx(mesh,
                                                                  rules)))
    assert callable(T.make_train_step(cfg, hp, SH.ShardingCtx(
        mesh, SH.DEFAULT_RULES, gather_fsdp=False)))
    assert callable(T.make_train_step(
        cfg, T.TrainHParams(opt_impl="adamw8bit"),
        SH.ShardingCtx(mesh, SH.DEFAULT_RULES)))
    for arch in ("mamba2-2.7b", "jamba-1.5-large-398b"):
        assert callable(T.make_train_step(
            get_reduced(arch), hp, SH.ShardingCtx(mesh, SH.DEFAULT_RULES)))
    with pytest.raises(ValueError, match="moe_impl"):
        T.make_train_step(cfg, hp, SH.ShardingCtx(mesh, SH.DEFAULT_RULES,
                                                  moe_impl="ring"))


def test_regc_inner_ctx_refusals():
    """The reference's two refusals of an inner ctx: a rule on a dp axis
    ('data' is a manual axis of its shard_map) and the nested shard_map
    of moe_impl='ep'."""
    cfg = get_reduced("internlm2-1.8b")
    mesh = _Shape(data=2, model=4)
    with pytest.raises(ValueError, match="manual axes"):
        T.make_train_step_regc(cfg, T.TrainHParams(), mesh,
                               inner_ctx=SH.ShardingCtx(mesh,
                                                        SH.DEFAULT_RULES))
    no_dp = dict(SH.DEFAULT_RULES, batch=None, embed_fsdp=None)
    with pytest.raises(ValueError, match="shard_map"):
        T.make_train_step_regc(cfg, T.TrainHParams(), mesh,
                               inner_ctx=SH.ShardingCtx(mesh, no_dp,
                                                        moe_impl="ep"))


# ---------------------------------------------------------------------------
# the Trainer under a ctx on two ranks
# ---------------------------------------------------------------------------


def _mk_trainer(root, ctx, *, steps=12, ckpt_every=4, injector=None):
    """tests/test_trainer.py's settings under ``ctx``."""
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_reduced("internlm2-1.8b")
    hp = T.TrainHParams(lr=1e-3, warmup=2, total_steps=steps, remat=None,
                        ce_chunk=32)
    tc = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(root / "ckpts"), log_every=1000,
                       ckpt_async=True)
    data = DataConfig(kind="synthetic", vocab_size=cfg.vocab_size,
                      seq_len=32, global_batch=4)
    return Trainer(cfg, hp, tc, data, mesh=ctx.mesh, ctx=ctx,
                   injector=injector, log_fn=lambda *_: None, device="cpu")


def trainer_rank(root: str):
    from repro_torch.ft import FailureInjector
    root = Path(root)
    mesh = make_host_mesh((1, 2), ("data", "model"))
    ctx = SH.ShardingCtx(mesh, SH.DEFAULT_RULES)
    cfg = get_reduced("internlm2-1.8b")
    out = {}
    run = _mk_trainer(root / "runs", ctx).run()
    full = T.gather_state(cfg, ctx, run["params"])
    out["runs"] = {"step": run["step"], "history": run["history"],
                   "final": _flat(full)}
    inj = _mk_trainer(root / "injected", ctx,
                      injector=FailureInjector(at_steps=[9])).run()
    out["injected"] = {"step": inj["step"], "restarts": inj["restarts"],
                       "steps_seen": [h["step"] for h in inj["history"]]}
    ref = _mk_trainer(root / "a", ctx, steps=8, ckpt_every=4).run()
    rec = _mk_trainer(root / "b", ctx, steps=8, ckpt_every=4,
                      injector=FailureInjector(at_steps=[6])).run()
    out["replay"] = {
        "restarts": rec["restarts"],
        "equal": all(torch.equal(a, b) for a, b in zip(
            tree_leaves([ref["params"], ref["opt"]]),
            tree_leaves([rec["params"], rec["opt"]])))}
    return out


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_trainer")
    got = spawn_ranks(2, "test_torch_tp_train:trainer_rank",
                      (str(tmp / "t"),), backend="gloo",
                      init_method=f"file://{tmp / 'store'}", timeout_s=300)
    return tmp / "t", got


def test_sharded_trainer_runs_and_checkpoints(trainers):
    root, got = trainers
    for g in got:
        out = g["runs"]
        assert out["step"] == 12 and len(out["history"]) == 12
        assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert [h["loss"] for h in got[0]["runs"]["history"]] == \
        [h["loss"] for h in got[1]["runs"]["history"]]
    ckpts = sorted((root / "runs" / "ckpts").glob("step_*"))
    assert [c.name for c in ckpts] == ["step_000000004", "step_000000008",
                                       "step_000000012"]
    assert restore_extra(root / "runs" / "ckpts", 12)["loss"] == \
        got[0]["runs"]["history"][-1]["loss"]


def test_sharded_trainer_survives_injected_failure(trainers):
    _, got = trainers
    for g in got:
        out = g["injected"]
        assert out["restarts"] == 1 and out["step"] == 12
        assert out["steps_seen"].count(9) == 1 and 8 in out["steps_seen"]


def test_sharded_restart_is_exact_replay(trainers):
    _, got = trainers
    assert all(g["replay"]["restarts"] == 1 and g["replay"]["equal"]
               for g in got)


def test_sharded_checkpoint_is_the_gathered_tree(trainers):
    """The last checkpoint, read by the one-process port in the
    reference's layout, holds the ranks' gathered parameters bit for
    bit."""
    root, got = trainers
    cfg = get_reduced("internlm2-1.8b")
    params, opt = T.init_train_state(cfg, device="cpu")
    state = restore_checkpoint(root / "runs" / "ckpts", 12,
                               {"params": params, "opt": opt})
    final = got[0]["runs"]["final"]
    assert set(final) == {k for k, _ in tree_flatten(state["params"])}
    for k, v in tree_flatten(state["params"]):
        np.testing.assert_array_equal(v.numpy(), final[k], err_msg=k)
