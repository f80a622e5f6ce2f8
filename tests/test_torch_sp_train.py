"""The port's training under the serving half's mechanisms
(``make_train_step(cfg, hp, ctx)`` under ``TRAIN_SP_RULES``' ``seq_sp``
boundaries, SSM layers in a sharded step, ``adamw8bit`` under a ctx, the
serving tables and ``gather_fsdp=False``) over gloo ranks on the CPU,
against the reference's GSPMD step.

One JAX subprocess with 8 host devices writes, for each case, the
parameters (``PRNGKey(0)``), the batch (8 x 64 tokens and targets from
``PRNGKey(1)``: 64 divides every ``seq_sp`` split and the reduced SSM's
chunk of 32) and the reference's jitted step (loss, grad norm, updated
parameters and optimiser state), its gradients and the loss's
``aux_loss`` / ``expert_load``.  Reduced configs keep two super-blocks
(``n_periods=2``) where a boundary matters; jamba's one super-block
holds its eight layers.  Cases, on mesh (2, 4) ``("data", "model")``
unless noted: internlm2-1.8b under ``TRAIN_SP_RULES`` (remat "full",
and "dots" against it), ``DEFAULT_RULES`` with ``adamw8bit`` (the LM
head's vocabulary over 'model' cuts its 128-blocks),
``LONG_CONTEXT_RULES`` (batch None) and ``DECODE_2D_RULES`` with
``gather_fsdp=False``; mamba2-2.7b under ``DEFAULT_RULES`` (``ssm_in``
over model, FSDP over data), ``SMALL_MODEL_RULES``, ``TRAIN_SP_RULES``
with ``adamw8bit`` in 2 microbatches and ``DECODE_2D_RULES`` with
``gather_fsdp=False``; jamba-1.5-large-398b under ``DEFAULT_RULES``
(``capacity_factor=4.0``: SSD, attention and MoE together); llama3-405b
under ``LONG_2D_RULES`` with ``gather_fsdp=False`` on (2, 2, 2)
``("pod", "data", "model")``; moonshot-v1-16b-a3b (MoE with shared
experts) under ``DECODE_2D_RULES`` with ``gather_fsdp=False`` (the
routing weights scale each rank's d_model block of the experts'
outputs).  ``FUZZ_TORCH=1`` adds internlm2 under
``SERVE_RULES`` and under ``DEFAULT_RULES`` with ``gather_fsdp=False``,
and grok-1-314b under ``TRAIN_SP_RULES`` with ``moe_impl="ep"``.

Eight spawned gloo ranks run the port from the carried parameters, each
on its blocks.  Checked: loss within 1e-5 relative; gathered gradients
within 1e-4 of each leaf's largest |value|; updated parameters at the
reference's rtol 5e-3 / atol 5e-5; MoE stats within 1e-5; every block
held by several ranks bit-equal (a digest of the parameters, the
optimiser state and the gradients); the same step within the same
tolerances of the port's one-process step; ``adamw8bit`` against the
reference (scales 1e-5 relative, int8 codes within 1) and, exactly, its
sharded update applied twice to the reference's gathered gradients
against the one-process ``adamw8bit_update`` on the same gradients and
square norm (codes, scales and parameters bit-equal); under
``TRAIN_SP_RULES`` and remat "full" the residual each checkpoint saves
holds S / |model| positions and the carry's all-gathers over 'model'
number one a super-block in forward, one in the recompute and one in
the backward (the boundary's gradient blocks); under the 2-D tables no
parameter is gathered in the whole step.

Two ranks run ``tests/test_trainer.py``'s trainer cases on reduced
mamba2 under ``TRAIN_SP_RULES`` with ``adamw8bit`` (mesh (1, 2)): runs
and checkpoints, survives an injected failure, a restart is an exact
replay; the checkpoint, read back by the one-process port, equals the
gathered parameters and int8 state.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import collectives as C
from repro_torch.models import sharding as SH
from repro_torch.models.model import param_specs
from repro_torch.optim import quantized as Q
from repro_torch.optim.adamw import init_opt_state, warmup_cosine
from repro_torch.train import train_step as T
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
FUZZ = os.environ.get("FUZZ_TORCH") == "1"

WORLD = 8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 5e-5
STAT_TOL = 1e-5
SCALE_RTOL = 1e-5
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (tag, arch, n_periods, mesh, rules, gather_fsdp, moe_impl, n_micro,
#  opt_impl)
CASES = (
    ("sp_internlm2", "internlm2-1.8b", 2, "2x4", "TRAIN_SP_RULES", True,
     "dense", 1, "adamw"),
    ("mamba2_default", "mamba2-2.7b", 2, "2x4", "DEFAULT_RULES", True,
     "dense", 1, "adamw"),
    ("mamba2_small", "mamba2-2.7b", 2, "2x4", "SMALL_MODEL_RULES", True,
     "dense", 1, "adamw"),
    ("mamba2_sp_q8", "mamba2-2.7b", 2, "2x4", "TRAIN_SP_RULES", True,
     "dense", 2, "adamw8bit"),
    ("jamba_default", "jamba-1.5-large-398b", 1, "2x4", "DEFAULT_RULES",
     True, "dense", 1, "adamw"),
    ("internlm2_q8", "internlm2-1.8b", 2, "2x4", "DEFAULT_RULES", True,
     "dense", 1, "adamw8bit"),
    ("internlm2_long", "internlm2-1.8b", 2, "2x4", "LONG_CONTEXT_RULES",
     True, "dense", 1, "adamw"),
    ("internlm2_2d", "internlm2-1.8b", 2, "2x4", "DECODE_2D_RULES", False,
     "dense", 1, "adamw"),
    ("mamba2_2d", "mamba2-2.7b", 2, "2x4", "DECODE_2D_RULES", False,
     "dense", 1, "adamw"),
    ("llama3_long2d", "llama3-405b", 2, "2x2x2", "LONG_2D_RULES", False,
     "dense", 1, "adamw"),
    ("moonshot_2d", "moonshot-v1-16b-a3b", 2, "2x4", "DECODE_2D_RULES",
     False, "dense", 1, "adamw"),
) + ((
    ("internlm2_serve", "internlm2-1.8b", 2, "2x4", "SERVE_RULES", True,
     "dense", 1, "adamw"),
    ("internlm2_nogather", "internlm2-1.8b", 2, "2x4", "DEFAULT_RULES",
     False, "dense", 1, "adamw"),
    ("grok_sp_ep", "grok-1-314b", 2, "2x4", "TRAIN_SP_RULES", True, "ep",
     1, "adamw"),
) if FUZZ else ())
SP_TAG = "sp_internlm2"         # also run under remat "dots" and None
B, S = 8, 64
# the port's remat for each case (the reference's values do not depend
# on it; it runs without)
REMAT = {"sp_internlm2": "full", "mamba2_sp_q8": "full"}


def _cfg(arch, periods, lib):
    cfg = lib.get_reduced(arch, n_periods=periods)
    if cfg.moe is not None:         # nothing drops: no near-tie routing
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


REF_SCRIPT = r"""
import dataclasses
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax import lax
from repro.compat import make_mesh
from repro import configs
from repro.models import model as M
from repro.models import sharding as SH
from repro.optim.adamw import adamw_update, init_opt_state, warmup_cosine
from repro.optim.quantized import adamw8bit_update, init_opt_state_q8
from repro.train.train_step import (TrainHParams, _constrain_batch,
                                    _microbatch, make_train_step)
from repro.utils.tree import tree_add, tree_scale, tree_zeros_like

out_path, spec = sys.argv[1], eval(sys.argv[2])
B, S = spec["B"], spec["S"]
res = {}
meshes = {k: make_mesh(shape, axes) for k, (shape, axes) in
          spec["meshes"].items()}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


def step_and_grads(cfg, hp, ctx):
    # make_train_step's body, its gradients and metrics returned as well
    sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    opt_update = (adamw8bit_update if hp.opt_impl == "adamw8bit"
                  else adamw_update)

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
        new_params, new_opt, gnorm = opt_update(params, grads, opt, step,
                                                sched(step), hp.adamw)
        return new_params, new_opt, loss, gnorm, grads, mts
    return jax.jit(fn)


step0 = jnp.zeros((), jnp.int32)
for (tag, arch, periods, mesh_key, rules, gather_fsdp, impl, n_micro,
     opt_impl) in spec["cases"]:
    cfg = configs.get_reduced(arch, n_periods=periods)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    params = M.init_model_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    batch = {"tokens": jax.random.randint(ks[0], (B, S), 0, cfg.vocab_size),
             "targets": jax.random.randint(ks[1], (B, S), 0,
                                           cfg.vocab_size)}
    ctx = SH.ShardingCtx(mesh=meshes[mesh_key], rules=getattr(SH, rules),
                         gather_fsdp=gather_fsdp, moe_impl=impl)
    hp = TrainHParams(remat=None, ce_chunk=32, n_micro=n_micro,
                      opt_impl=opt_impl)
    put(f"{tag}/in/params", params)
    res.update({f"{tag}/in/batch/{k}": np.asarray(v)
                for k, v in batch.items()})
    opt = (init_opt_state_q8(params) if opt_impl == "adamw8bit"
           else init_opt_state(params))
    p2, o2, loss, gnorm, g, mts = step_and_grads(cfg, hp, ctx)(
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
    if opt_impl == "adamw8bit":
        put(f"{tag}/opt", o2)
    res[f"{tag}/loss"] = np.asarray(loss)
    res[f"{tag}/grad_norm"] = np.asarray(gnorm)
    put(f"{tag}/grads", g)
    for k in ("aux_loss", "expert_load"):
        if k in mts:
            res[f"{tag}/{k}"] = np.asarray(mts[k])
np.savez(out_path, **res)
print("REF_OK")
"""


def run_reference(out: Path, spec) -> dict:
    """REF_SCRIPT on 8 host devices (LLVM's optimisation level 0: the
    compiles are faster, the programs XLA partitions and runs the
    same)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                           repr(spec)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _tree(template, arrays, prefix):
    return tree_unflatten(template, [
        torch.from_numpy(np.array(arrays[prefix + k]))
        for k, _ in tree_flatten(template)])


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


def _hp(opt_impl, n_micro, remat=None):
    return T.TrainHParams(remat=remat, ce_chunk=32, n_micro=n_micro,
                          opt_impl=opt_impl)


def _init_opt(params, opt_impl):
    return (Q.init_opt_state_q8(params) if opt_impl == "adamw8bit"
            else init_opt_state(params))


def _saved_in_forward(cfg, ctx, lp, batch, remat):
    """The shapes of every tensor the training loss's forward saves for
    its backward outside a checkpoint (each checkpoint's inputs among
    them), on this rank's blocks under remat ``remat``."""
    from repro_torch.models.model import loss_fn
    layout = T.batch_layout(cfg, ctx, batch)
    params = tree_unflatten(lp, [p.detach().requires_grad_(True)
                                 for p in tree_leaves(lp)])
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn(cfg, params, T.local_rows(cfg, batch, layout), remat=remat,
                ce_chunk=32, layout=layout)
    return shapes


def step_rank(ref_path: str, cases):
    """One rank: every case's sharded step from the reference's state."""
    import torch.distributed as dist
    from repro_torch import configs
    rank = dist.get_rank()
    with np.load(ref_path) as z:
        ref = dict(z)
    meshes = {k: make_host_mesh(*v) for k, v in MESHES.items()}
    out = {}
    for (tag, arch, periods, mesh_key, rules, gather_fsdp, impl, n_micro,
         opt_impl) in cases:
        cfg = _cfg(arch, periods, configs)
        mesh = meshes[mesh_key]
        ctx = SH.ShardingCtx(mesh, getattr(SH, rules),
                             gather_fsdp=gather_fsdp, moe_impl=impl)
        spec_tree = param_specs(cfg)
        specs = SH.param_shardings(spec_tree, ctx)
        ospecs = SH.opt_shardings(spec_tree, ctx, opt_impl)
        params = _tree(spec_tree, ref, f"{tag}/in/params")
        batch = _batch(ref, tag)
        hp = _hp(opt_impl, n_micro, REMAT.get(tag))
        lp, lo = T.shard_state(cfg, ctx, params, _init_opt(params, opt_impl))
        C.reset_collectives()
        p2, o2, m, g = T.make_train_step(cfg, hp, ctx)(lp, lo, batch, 0,
                                                       with_grads=True)
        row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "msgs": dict(C.COLLECTIVE_MSGS),
               "param_gathers": dict(C.PARAM_GATHERS),
               "digests": {**_digests(p2, specs, mesh),
                           **{("opt",) + k: v for k, v in
                              _digests(o2, ospecs, mesh).items()},
                           **{("g",) + k: v for k, v in
                              _digests(g, specs, mesh).items()}}}
        if n_micro == 1:
            _, mts = T.eval_loss(cfg, hp, lp, batch, ctx)
            row["stats"] = {k: mts[k].numpy() for k in
                            ("aux_loss", "expert_load") if k in mts}
        full_g = T.gather_state(cfg, ctx, g)
        full_p, full_o = T.gather_state(cfg, ctx, p2, o2)
        if rank == 0:
            row.update(grads=_flat(full_g), params=_flat(full_p))
            if opt_impl == "adamw8bit":
                row["opt"] = _flat(full_o)
        if opt_impl == "adamw8bit":
            # the sharded update alone, twice, on the reference's
            # gradients (the second dequantizes the first's state)
            rg = _tree(spec_tree, ref, f"{tag}/grads")
            gl = T.shard_state(cfg, ctx, rg)
            q8 = T.q8_shards(cfg, ctx)
            sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
            qp, qo, sqs = lp, lo, []
            for step in (0, 1):
                sq = T.sharded_sq_norm(gl, T.leaf_specs(cfg, ctx), mesh)
                qp, qo, _ = Q.adamw8bit_update(
                    qp, gl, qo, step, sched(step), hp.adamw, sq_norm=sq,
                    shards=(q8, mesh))
                sqs.append(float(sq))
            fq, fo = T.gather_state(cfg, ctx, qp, qo)
            if rank == 0:
                row["exact"] = {"sq": sqs, "params": _flat(fq),
                                "opt": _flat(fo)}
        if tag == SP_TAG:
            # remat changes memory, never values; the boundaries' blocks
            for remat in ("dots", None):
                C.reset_collectives()
                _, _, mr, gr = T.make_train_step(
                    cfg, _hp(opt_impl, n_micro, remat), ctx)(
                    lp, lo, batch, 0, with_grads=True)
                row[f"remat_{remat}"] = {
                    "loss": float(mr["loss"]), "msgs": dict(C.COLLECTIVE_MSGS),
                    "grad_err": max(float((a - b).abs().max()) for a, b in
                                    zip(tree_leaves(gr), tree_leaves(g)))}
            # what the forward saves, and without seq_sp (the same blocks
            # of the parameters: DEFAULT_RULES lays them out alike)
            row["saved"] = _saved_in_forward(cfg, ctx, lp, batch, "full")
            row["saved_default"] = _saved_in_forward(
                cfg, SH.ShardingCtx(mesh, SH.DEFAULT_RULES), lp, batch,
                "full")
        out[tag] = row
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_train")
    ref = run_reference(tmp / "ref.npz", {
        "B": B, "S": S, "meshes": MESHES, "cases": list(CASES),
        "check_step": "sp_internlm2"})
    got = spawn_ranks(WORLD, "test_torch_sp_train:step_rank",
                      (str(tmp / "ref.npz"), CASES), backend="gloo",
                      init_method=f"file://{tmp / 'store'}", timeout_s=600)
    return ref, got


def _case(tag):
    return next(c for c in CASES if c[0] == tag)


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


@pytest.mark.parametrize("tag", [c[0] for c in CASES if c[7] == 1])
def test_sharded_moe_stats_match_reference(steps, tag):
    ref, got = steps
    stats = got[0][tag]["stats"]
    assert set(stats) == {k for k in ("aux_loss", "expert_load")
                          if f"{tag}/{k}" in ref}
    for k, v in stats.items():
        np.testing.assert_allclose(v, ref[f"{tag}/{k}"], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_replicas_stay_bit_equal(steps, tag):
    """Every block held by several ranks has the same bits on each (the
    parameters, the optimiser state and the gradients), and every rank
    reports the same loss and grad norm."""
    _, got = steps
    seen = {}
    for g in got:
        for key, digest in g[tag]["digests"].items():
            assert seen.setdefault(key, digest) == digest, (tag, key)
    assert len({(g[tag]["loss"], g[tag]["grad_norm"]) for g in got}) == 1


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_sharded_step_matches_one_process_step(steps, tag):
    """The ranks' step against the port's one-process step on the global
    batch, with moe_block at the ctx's dispatch groups."""
    from repro_torch import configs
    ref, got = steps
    _, arch, periods, mesh_key, rules, _, impl, n_micro, opt_impl = _case(
        tag)
    cfg = _cfg(arch, periods, configs)
    shape = dict(zip(MESHES[mesh_key][1], MESHES[mesh_key][0]))
    ep = (impl == "ep" and cfg.moe is not None
          and cfg.moe.n_experts % shape["model"] == 0)
    axes = tuple(a for a in (getattr(SH, rules)["batch"] or ())
                 if a in shape and not (ep and a == "model"))
    groups = int(np.prod([shape[a] for a in axes]))
    params = _tree(param_specs(cfg), ref, f"{tag}/in/params")
    p1, _, m1, g1 = T.make_train_step(
        cfg, _hp(opt_impl, n_micro), moe_groups=groups, moe_group_aux=ep)(
        params, _init_opt(params, opt_impl), _batch(ref, tag), 0,
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


Q8_TAGS = [c[0] for c in CASES if c[8] == "adamw8bit"]


@pytest.mark.parametrize("tag", Q8_TAGS)
def test_adamw8bit_state_matches_reference(steps, tag):
    """The gathered int8 state after the sharded step: scales within
    1e-5 relative, codes within 1 of the reference's (the gradients
    differ in their last bits)."""
    ref, got = steps
    opt = got[0][tag]["opt"]
    assert set(opt) == {k[len(f"{tag}/opt"):] for k in ref
                        if k.startswith(f"{tag}/opt")}
    for k, v in opt.items():
        want = ref[f"{tag}/opt{k}"]
        assert v.dtype == want.dtype and v.shape == want.shape, k
        if k.endswith("_q']"):
            assert np.abs(v.astype(np.int32) - want.astype(np.int32)).max() \
                <= 1, k
        else:
            np.testing.assert_allclose(v, want, rtol=SCALE_RTOL, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("tag", Q8_TAGS)
def test_sharded_adamw8bit_update_is_exact(steps, tag):
    """The sharded int8 update, applied twice to the reference's
    gradients, gives codes, scales and parameters bit-equal, block by
    block, to the one-process ``adamw8bit_update`` on the same gradients
    and square norm."""
    from repro_torch import configs
    ref, got = steps
    _, arch, periods, *_ = _case(tag)
    cfg = _cfg(arch, periods, configs)
    spec_tree = param_specs(cfg)
    params = _tree(spec_tree, ref, f"{tag}/in/params")
    grads = _tree(spec_tree, ref, f"{tag}/grads")
    row = got[0][tag]["exact"]
    hp = _hp("adamw8bit", 1)
    sched = warmup_cosine(hp.lr, hp.warmup, hp.total_steps)
    p, st = params, Q.init_opt_state_q8(params)
    for step, sq in zip((0, 1), row["sq"]):
        p, st, _ = Q.adamw8bit_update(
            p, grads, st, step, sched(step), hp.adamw,
            sq_norm=torch.tensor(sq, dtype=torch.float32))
    for k, v in _flat(st).items():
        np.testing.assert_array_equal(row["opt"][k], v, err_msg=k)
    for k, v in _flat(p).items():
        np.testing.assert_array_equal(row["params"][k], v, err_msg=k)


def test_seq_sp_saves_blocks_of_the_boundary(steps):
    """Under TRAIN_SP_RULES and remat "full" each checkpoint saves this
    rank's S / |model| positions of the residual (B / |data| rows of
    d_model): one a super-block, where the same step under DEFAULT_RULES
    saves the whole sequence there."""
    from repro_torch import configs
    _, got = steps
    cfg = _cfg("internlm2-1.8b", 2, configs)
    block, whole = (B // 2, S // 4, cfg.d_model), (B // 2, S, cfg.d_model)
    for g in got:
        row = g[SP_TAG]
        assert row["saved"].count(block) == cfg.n_superblocks
        assert row["saved_default"].count(block) == 0
        assert row["saved"].count(whole) == \
            row["saved_default"].count(whole) - cfg.n_superblocks


@pytest.mark.parametrize("remat", ["full", "dots", None])
def test_seq_sp_carry_gathers(steps, remat):
    """The carry's all-gathers over 'model': one a super-block in
    forward, one in the remat recompute and one in the backward (the
    boundary's gradient blocks), and nothing else gathers over 'model'
    in this case (its kv heads are replicated)."""
    from repro_torch import configs
    _, got = steps
    n = _cfg("internlm2-1.8b", 2, configs).n_superblocks
    per = {"full": 3, "dots": 3, None: 2}[remat]
    for g in got:
        row = g[SP_TAG] if remat == "full" else g[SP_TAG][f"remat_{remat}"]
        assert row["msgs"][("all-gather", ("model",))] == per * n


@pytest.mark.parametrize("remat", ["dots", None])
def test_remat_changes_no_value(steps, remat):
    """Remat changes memory, never values: the same loss and gradients
    within float32 reordering (1e-6 absolute) on every rank."""
    _, got = steps
    for g in got:
        row = g[SP_TAG]
        assert row[f"remat_{remat}"]["loss"] == row["loss"]
        assert row[f"remat_{remat}"]["grad_err"] <= 1e-6


@pytest.mark.parametrize("tag", [c[0] for c in CASES if not c[5]])
def test_no_parameter_gathered_without_gather_fsdp(steps, tag):
    """Under the 2-D tables with gather_fsdp=False no weight moves in
    the whole step, backward included."""
    _, got = steps
    rules = getattr(SH, _case(tag)[4])
    for g in got:
        if rules["batch"] is None:
            assert g[tag]["param_gathers"] == {"bytes": 0, "messages": 0}
        assert sum(g[tag]["msgs"].values()) > 0


# ---------------------------------------------------------------------------
# the Trainer under TRAIN_SP_RULES with adamw8bit on two ranks
# ---------------------------------------------------------------------------


def _mk_trainer(root, ctx, *, steps=12, ckpt_every=4, injector=None):
    """tests/test_trainer.py's settings on reduced mamba2, ``adamw8bit``."""
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_reduced("mamba2-2.7b")
    hp = T.TrainHParams(lr=1e-3, warmup=2, total_steps=steps, remat=None,
                        ce_chunk=32, opt_impl="adamw8bit")
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
    ctx = SH.ShardingCtx(mesh, SH.TRAIN_SP_RULES)
    cfg = get_reduced("mamba2-2.7b")
    out = {}
    run = _mk_trainer(root / "runs", ctx).run()
    full_p, full_o = T.gather_state(cfg, ctx, run["params"], run["opt"])
    out["runs"] = {"step": run["step"], "history": run["history"],
                   "final": _flat(full_p), "final_opt": _flat(full_o)}
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
    tmp = tmp_path_factory.mktemp("sp_trainer")
    got = spawn_ranks(2, "test_torch_sp_train:trainer_rank",
                      (str(tmp / "t"),), backend="gloo",
                      init_method=f"file://{tmp / 'store'}", timeout_s=300)
    return tmp / "t", got


def test_sp_q8_trainer_runs_and_checkpoints(trainers):
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


def test_sp_q8_trainer_survives_injected_failure(trainers):
    _, got = trainers
    for g in got:
        out = g["injected"]
        assert out["restarts"] == 1 and out["step"] == 12
        assert out["steps_seen"].count(9) == 1 and 8 in out["steps_seen"]


def test_sp_q8_restart_is_exact_replay(trainers):
    _, got = trainers
    assert all(g["replay"]["restarts"] == 1 and g["replay"]["equal"]
               for g in got)


def test_sp_q8_checkpoint_is_the_gathered_int8_tree(trainers):
    """The last checkpoint, read by the one-process port in the
    reference's layout (the parameters and, a leaf, its int8 codes and
    float32 scales), holds the ranks' gathered state bit for bit."""
    root, got = trainers
    cfg = get_reduced("mamba2-2.7b")
    params, _ = T.init_train_state(cfg, device="cpu")
    opt = Q.init_opt_state_q8(params)
    state = restore_checkpoint(root / "runs" / "ckpts", 12,
                               {"params": params, "opt": opt})
    final, final_opt = got[0]["runs"]["final"], got[0]["runs"]["final_opt"]
    assert set(final) == {k for k, _ in tree_flatten(state["params"])}
    assert set(final_opt) == {k for k, _ in tree_flatten(state["opt"])}
    for k, v in tree_flatten(state["params"]):
        np.testing.assert_array_equal(v.numpy(), final[k], err_msg=k)
    for k, v in tree_flatten(state["opt"]):
        assert v.dtype in (torch.int8, torch.float32), k
        np.testing.assert_array_equal(v.numpy(), final_opt[k], err_msg=k)
