"""The port's explicit RegC train path (``train.train_step.
make_train_step_regc``, ``Trainer(path="regc")``, ``launch.train --path
regc``) on gloo ranks on the CPU, against the reference.

One JAX subprocess with 8 host devices (as ``tests/test_regc_sync.py``
runs ``TRAIN_EQUIV_SCRIPT``) writes the reduced internlm2's parameters
(``PRNGKey(0)``), the batch (16 x 32 from ``PRNGKey(1)``) and, for each
of the four ``TRAIN_EQUIV_SCRIPT`` policies (lazy_object, lazy_bucket,
eager_object at n_micro 2, lazy_micro), the reference's
``make_train_step_regc`` step (jitted) and its synced gradients (the
reference's ``barrier_sync_grads`` over each device's gradients, as the
step's ``shard_map`` body makes them).  It also writes the inputs of
``benchmarks/regc_training.py`` (``n_periods=2``, 16 x 64, n_micro 2),
drawn with ``jax_threefry_partitionable`` off as jax 0.4, which made the
CSV, drew them (newer jax's default stream gives other parameters).

Eight spawned gloo ranks run the port's step from the carried state:

* loss within 1e-5 relative of the reference's; the psum policies'
  synced gradients within 1e-4 of each leaf's largest |value|; updated
  parameters at the reference's own rtol 5e-3 / atol 5e-5;
* eager_object against lazy_micro, and lazy_object against the port's
  one-process ``make_train_step`` on the global batch, at the same rtol;
* every rank's parameters, moments and gradients bit-equal (sha256);
* the four ``artifacts/bench/regc_training.csv`` rows: loss within 1e-5
  relative, ``collective_bytes_per_dev``, ``coll_msgs``, ``ar_bytes``
  and ``permute_bytes`` equal to the port's counted collectives
  (``wall_s_per_step`` not compared).

Two ranks run ``tests/test_trainer.py``'s trainer cases on the regc path
(runs and checkpoints; survives an injected failure; a restart is an
exact replay), and ``launch.train --path regc`` runs under
``python -m torch.distributed.run --standalone --nproc-per-node 2``.
"""
import csv
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore_extra
from repro_torch.configs import get_reduced
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.model import param_specs
from repro_torch.optim.adamw import init_opt_state
from repro_torch.regc_sync import policies as P
from repro_torch.train.train_step import (
    TrainHParams, make_train_step, make_train_step_regc,
)
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten
from test_torch_regc_sync import run_reference

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 5e-5
# TRAIN_EQUIV_SCRIPT's policies (tag, policy, n_micro)
EQUIV = (("lazy_object", P.RegCSyncPolicy("lazy", "object"), 1),
         ("lazy_bucket", P.RegCSyncPolicy("lazy", "bucket", 1 << 16), 1),
         ("eager_object", P.RegCSyncPolicy("eager", "object"), 2),
         ("lazy_micro", P.RegCSyncPolicy("lazy", "object"), 2))
# benchmarks/regc_training.py's POLICIES
CSV_POLICIES = (
    ("lazy_object", P.RegCSyncPolicy("lazy", "object"), 2),
    ("lazy_bucket", P.RegCSyncPolicy("lazy", "bucket", 1 << 20), 2),
    ("eager_object", P.RegCSyncPolicy("eager", "object"), 2),
    ("int8_ring", P.RegCSyncPolicy("lazy", "object",
                                   compression="int8_ring"), 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _kw(p):
    return {"ordinary_sync": p.ordinary_sync, "granularity": p.granularity,
            "bucket_bytes": p.bucket_bytes, "compression": p.compression}


REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_reduced
from repro.models import model as M
from repro.optim.adamw import init_opt_state
from repro.regc_sync.policies import RegCSyncPolicy, barrier_sync_grads
from repro.train.train_step import (TrainHParams, _microbatch,
                                    make_train_step_regc)
from repro.utils.tree import tree_add, tree_scale, tree_zeros_like

out_path, spec = sys.argv[1], eval(sys.argv[2])
W = 8
mesh = make_mesh((W,), ("data",))
res = {}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


def inputs(cfg, B, S):
    params = M.init_model_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    batch = {"tokens": jax.random.randint(ks[0], (B, S), 0, cfg.vocab_size),
             "targets": jax.random.randint(ks[1], (B, S), 0, cfg.vocab_size)}
    return params, batch


def synced_grads(cfg, hp, params, batch):
    # make_train_step_regc's shard_map body up to the synced gradients
    sync = lambda g: barrier_sync_grads(g, ("data",), hp.sync,
                                        axis_sizes={"data": W})
    eager = hp.sync.ordinary_sync == "eager"

    def grad(p, b):
        return jax.grad(lambda q: M.loss_fn(
            cfg, q, b, None, attn_impl=hp.attn_impl, remat=hp.remat,
            ce_chunk=hp.ce_chunk, remat_segment=hp.remat_segment),
            has_aux=True)(p)[0]

    def inner(p, b):
        if hp.n_micro == 1:
            g = grad(p, b)
            g = sync(g) if eager else g
        else:
            mb = _microbatch(b, hp.n_micro, lambda k: 0)
            g = tree_zeros_like(p, jnp.float32)
            for i in range(hp.n_micro):
                gi = grad(p, {k: v[i] for k, v in mb.items()})
                g = tree_add(g, sync(gi) if eager else gi)
            g = tree_scale(g, 1.0 / hp.n_micro)
        return g if eager else sync(g)
    return jax.jit(shard_map(inner, mesh=mesh,
                             in_specs=(P(), {k: P("data") for k in batch}),
                             out_specs=P()))(params, batch)


cfg = get_reduced("internlm2-1.8b")
params, batch = inputs(cfg, 16, 32)
opt = init_opt_state(params)
put("params", params)
res.update({f"batch/{k}": np.asarray(v) for k, v in batch.items()})
step0 = jnp.zeros((), jnp.int32)
for tag, pol, n_micro in spec["equiv"]:
    hp = TrainHParams(remat=None, ce_chunk=32, n_micro=n_micro,
                      sync=RegCSyncPolicy(**pol))
    step = jax.jit(make_train_step_regc(cfg, hp, mesh, dp_axes=("data",)))
    p2, o2, m2 = step(params, opt, batch, step0)
    put(f"{tag}/params", p2)
    res[f"{tag}/loss"] = np.asarray(m2["loss"])
    res[f"{tag}/grad_norm"] = np.asarray(m2["grad_norm"])
    put(f"{tag}/grads", synced_grads(cfg, hp, params, batch))

# the CSV was made by jax 0.4, whose PRNGKey streams predate the
# partitionable threefry that newer jax draws by default
jax.config.update("jax_threefry_partitionable", False)
cfg2 = get_reduced("internlm2-1.8b", n_periods=2)
params2, batch2 = inputs(cfg2, 16, 64)
put("csv/params", params2)
res.update({f"csv/batch/{k}": np.asarray(v) for k, v in batch2.items()})
np.savez(out_path, **res)
print("REF_OK")
"""


def _tree(cfg, arrays, prefix):
    spec = param_specs(cfg)
    return tree_unflatten(spec, [torch.from_numpy(np.array(arrays[prefix + k]))
                                 for k, _ in tree_flatten(spec)])


def _flat(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree_flatten(tree)}


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for t in trees:
        for k, v in tree_flatten(t):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _counts():
    return {"ar_bytes": P.COLLECTIVE_BYTES["all-reduce"],
            "permute_bytes": P.COLLECTIVE_BYTES["collective-permute"],
            "msgs": sum(P.COLLECTIVE_MSGS.values())}


def step_rank(ref_path: str, equiv, csv_policies):
    """One rank: each policy's step from the reference's state."""
    import torch.distributed as dist
    rank = dist.get_rank()
    with np.load(ref_path) as z:
        ref = dict(z)
    mesh = make_host_mesh((WORLD,), ("data",))
    out = {}
    for name, cfg_, pols, prefix in (
            ("equiv", get_reduced("internlm2-1.8b"), equiv, ""),
            ("csv", get_reduced("internlm2-1.8b", n_periods=2), csv_policies,
             "csv/")):
        params = _tree(cfg_, ref, prefix + "params")
        batch = {k: torch.from_numpy(ref[f"{prefix}batch/{k}"])
                 for k in ("tokens", "targets")}
        for tag, pol, n_micro in pols:
            hp = TrainHParams(remat=None, ce_chunk=32, n_micro=n_micro,
                              sync=P.RegCSyncPolicy(**pol))
            step = make_train_step_regc(cfg_, hp, mesh, dp_axes=("data",))
            P.reset_collectives()
            p2, o2, m, g = step(params, init_opt_state(params), batch, 0,
                                with_grads=True)
            row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "lr": float(m["lr"]), "counts": _counts(),
                   "digest": _digest(p2, o2, g)}
            if rank == 0 and name == "equiv":
                row.update(params=_flat(p2), grads=_flat(g))
            out[f"{name}/{tag}"] = row
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("regc_train")
    ref = run_reference(REF_SCRIPT, tmp / "ref.npz",
                        {"equiv": [(t, _kw(p), n) for t, p, n in EQUIV]})
    got = spawn_ranks(
        WORLD, "test_torch_regc_train:step_rank",
        (str(tmp / "ref.npz"), [(t, _kw(p), n) for t, p, n in EQUIV],
         [(t, _kw(p), n) for t, p, n in CSV_POLICIES]),
        backend="gloo", init_method=f"file://{tmp / 'store'}")
    return ref, got


def _leaf_close(a, b, tol):
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a - b).max()) <= tol * scale


@pytest.mark.parametrize("tag", [t for t, _, _ in EQUIV])
def test_regc_step_matches_reference(steps, tag):
    ref, got = steps
    row = got[0][f"equiv/{tag}"]
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


@pytest.mark.parametrize("name", [f"equiv/{t}" for t, _, _ in EQUIV]
                         + [f"csv/{t}" for t, _, _ in CSV_POLICIES])
def test_ranks_stay_bit_equal(steps, name):
    _, got = steps
    rows = [g[name] for g in got]
    assert len({r["digest"] for r in rows}) == 1, name
    assert len({(r["loss"], r["grad_norm"], r["lr"]) for r in rows}) == 1


def test_eager_and_lazy_give_the_same_update(steps):
    """A data-race-free program: both consistent at the step barrier; only
    the traffic's schedule differs (TRAIN_EQUIV_SCRIPT's check)."""
    _, got = steps
    a, b = got[0]["equiv/eager_object"], got[0]["equiv/lazy_micro"]
    for k in a["params"]:
        np.testing.assert_allclose(a["params"][k], b["params"][k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_regc_step_matches_one_process_step(steps):
    """lazy_object on 8 ranks against the port's one-process step on the
    global batch."""
    ref, got = steps
    cfg = get_reduced("internlm2-1.8b")
    params = _tree(cfg, ref, "params")
    batch = {k: torch.from_numpy(ref[f"batch/{k}"])
             for k in ("tokens", "targets")}
    p1, _, m1 = make_train_step(cfg, TrainHParams(remat=None, ce_chunk=32))(
        params, init_opt_state(params), batch, 0)
    row = got[0]["equiv/lazy_object"]
    np.testing.assert_allclose(row["loss"], float(m1["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(row["grad_norm"], float(m1["grad_norm"]),
                               rtol=GRAD_TOL)
    for k, p in _flat(p1).items():
        np.testing.assert_allclose(row["params"][k], p, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def _csv_rows():
    with open(ROOT / "artifacts" / "bench" / "regc_training.csv") as f:
        return {r["policy"]: r for r in csv.DictReader(f)}


@pytest.mark.parametrize("tag", [t for t, _, _ in CSV_POLICIES])
def test_regc_training_csv_row(steps, tag):
    """benchmarks/regc_training.py's row: the loss, and the collectives
    the port counts on each rank equal to the reference's HLO counts."""
    _, got = steps
    want = _csv_rows()[tag]
    for g in got:
        row = g[f"csv/{tag}"]
        np.testing.assert_allclose(row["loss"], float(want["loss"]),
                                   rtol=LOSS_RTOL)
        c = row["counts"]
        assert c["ar_bytes"] + c["permute_bytes"] == float(
            want["collective_bytes_per_dev"])
        assert c["msgs"] == float(want["coll_msgs"])
        assert c["ar_bytes"] == float(want["ar_bytes"])
        assert c["permute_bytes"] == float(want["permute_bytes"])


def test_regc_step_refusals():
    """The reference's refusals of an inner_ctx (tensor parallelism inside
    the RegC path) stand: rules naming a dp axis and moe_impl='ep' raise;
    SSM layers and a rule on ``kv_seq`` (ROADMAP 13g) build a step; the
    step runs in a world of one."""
    from repro_torch.launch.ranks import init_world
    from repro_torch.models import sharding as SH
    cfg = get_reduced("internlm2-1.8b")

    class Shape:
        shape = {"data": 1, "model": 2}
    no_dp = dict(SH.DEFAULT_RULES, batch=None, embed_fsdp=None)
    with pytest.raises(ValueError, match="manual axes"):
        make_train_step_regc(cfg, TrainHParams(), Shape(),
                             inner_ctx=SH.ShardingCtx(Shape(),
                                                      SH.DEFAULT_RULES))
    with pytest.raises(ValueError, match="shard_map"):
        make_train_step_regc(cfg, TrainHParams(), Shape(),
                             inner_ctx=SH.ShardingCtx(Shape(), no_dp,
                                                      moe_impl="ep"))
    with pytest.raises(ValueError, match="moe_impl"):
        make_train_step_regc(cfg, TrainHParams(), Shape(),
                             inner_ctx=SH.ShardingCtx(Shape(), no_dp,
                                                      moe_impl="ring"))
    owned = init_world("gloo")
    try:
        mesh = make_host_mesh((1,), ("data",))
        assert mesh.shape == {"data": 1} and mesh.axis_index("data") == 0
        step = make_train_step_regc(cfg, TrainHParams(remat=None,
                                                      ce_chunk=16), mesh)
        params = _tree(cfg, {k: np.zeros(s.shape, np.float32) for k, s in
                             tree_flatten(param_specs(cfg))}, "")
        with pytest.raises(ValueError, match="mesh"):
            Mesh((2,), ("data",))
        p2, _, m = step(params, init_opt_state(params),
                        {"tokens": torch.zeros((1, 16), dtype=torch.int32),
                         "targets": torch.zeros((1, 16), dtype=torch.int32)},
                        0)
        assert torch.isfinite(m["loss"])
        mesh2 = make_host_mesh((1, 1), ("data", "model"))
        assert callable(make_train_step_regc(
            get_reduced("mamba2-2.7b"), TrainHParams(), mesh2,
            inner_ctx=SH.ShardingCtx(mesh2, no_dp)))
        assert callable(make_train_step_regc(
            cfg, TrainHParams(), mesh2,
            inner_ctx=SH.ShardingCtx(mesh2, dict(no_dp, kv_seq=("model",)))))
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the Trainer and launch.train on two ranks
# ---------------------------------------------------------------------------


def _mk_trainer(root, mesh, *, steps=12, ckpt_every=4, injector=None):
    """tests/test_trainer.py's settings on the regc path."""
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_reduced("internlm2-1.8b")
    hp = TrainHParams(lr=1e-3, warmup=2, total_steps=steps, remat=None,
                      ce_chunk=32,
                      sync=P.RegCSyncPolicy(granularity="object",
                                            compression="int8_ring"))
    tc = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(root / "ckpts"), log_every=1000,
                       ckpt_async=True, path="regc")
    data = DataConfig(kind="synthetic", vocab_size=cfg.vocab_size,
                      seq_len=32, global_batch=4)
    return Trainer(cfg, hp, tc, data, mesh=mesh, injector=injector,
                   log_fn=lambda *_: None, device="cpu")


def trainer_rank(root: str):
    """tests/test_trainer.py's three cases on this rank."""
    from repro_torch.ft import FailureInjector
    root = Path(root)
    mesh = make_host_mesh((2,), ("data",))
    out = {}
    run = _mk_trainer(root / "runs", mesh).run()
    out["runs"] = {"step": run["step"], "history": run["history"],
                   "digest": _digest(run["params"], run["opt"])}
    inj = _mk_trainer(root / "injected", mesh,
                      injector=FailureInjector(at_steps=[9])).run()
    out["injected"] = {"step": inj["step"], "restarts": inj["restarts"],
                       "steps_seen": [h["step"] for h in inj["history"]]}
    ref = _mk_trainer(root / "a", mesh, steps=8, ckpt_every=4).run()
    rec = _mk_trainer(root / "b", mesh, steps=8, ckpt_every=4,
                      injector=FailureInjector(at_steps=[6])).run()
    out["replay"] = {
        "restarts": rec["restarts"],
        "equal": all(torch.equal(a, b) for a, b in zip(
            tree_leaves([ref["params"], ref["opt"]]),
            tree_leaves([rec["params"], rec["opt"]]))),
        "digest": _digest(rec["params"], rec["opt"])}
    return out


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("regc_trainer")
    got = spawn_ranks(2, "test_torch_regc_train:trainer_rank",
                      (str(tmp / "t"),), backend="gloo",
                      init_method=f"file://{tmp / 'store'}")
    return tmp / "t", got


def test_regc_trainer_runs_and_checkpoints(trainers):
    root, got = trainers
    for g in got:
        out = g["runs"]
        assert out["step"] == 12 and len(out["history"]) == 12
        assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert [h["loss"] for h in got[0]["runs"]["history"]] == \
        [h["loss"] for h in got[1]["runs"]["history"]]
    assert got[0]["runs"]["digest"] == got[1]["runs"]["digest"]
    ckpts = sorted((root / "runs" / "ckpts").glob("step_*"))
    assert [c.name for c in ckpts] == ["step_000000004", "step_000000008",
                                       "step_000000012"]
    assert restore_extra(root / "runs" / "ckpts", 12)["loss"] == \
        got[0]["runs"]["history"][-1]["loss"]


def test_regc_trainer_survives_injected_failure(trainers):
    """Every rank fails at step 9 and restarts from the step-8
    checkpoint."""
    _, got = trainers
    for g in got:
        out = g["injected"]
        assert out["restarts"] == 1 and out["step"] == 12
        assert out["steps_seen"].count(9) == 1 and 8 in out["steps_seen"]


def test_regc_restart_is_exact_replay(trainers):
    _, got = trainers
    assert all(g["replay"]["restarts"] == 1 and g["replay"]["equal"]
               for g in got)
    assert got[0]["replay"]["digest"] == got[1]["replay"]["digest"]


def test_launch_train_regc_two_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--path", "regc", "--sync-compression", "int8_ring", "--device",
         "cpu", "--steps", "6", "--ckpt-every", "3", "--seq-len", "16",
         "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("done: step=6") for line in lines) == 1
    ranks = [line for line in lines if line.startswith("ranks: world=2")]
    assert len(ranks) == 1 and "backend=gloo" in ranks[0]
    losses = eval(ranks[0].split("final_losses=")[1].split(" launches=")[0])
    assert len(losses) == 2 and losses[0] == losses[1]
    # on the CPU the wrappers run their plain versions: no launch
    assert eval(ranks[0].split(" launches=")[1]) == {"flash_attention": 0,
                                                      "ssd_chunk": 0}
    assert latest_step(tmp_path / "ck") == 6


def test_launch_train_regc_one_process(tmp_path, capsys):
    """Without torch.distributed.run's environment the world is this one
    process."""
    for k in ("RANK", "WORLD_SIZE"):
        assert k not in os.environ
    out = launch_train.main(["--path", "regc", "--device", "cpu",
                             "--steps", "3", "--seq-len", "16",
                             "--sync-granularity", "object",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert out["step"] == 3 and out["final_losses"] == [
        out["history"][-1]["loss"]]
    text = capsys.readouterr().out
    assert "done: step=3" in text and "ranks: world=1 backend=gloo" in text
    assert latest_step(tmp_path / "ck") == 3
    import torch.distributed as dist
    assert not dist.is_initialized()
