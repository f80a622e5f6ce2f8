"""The port's Trainer (``repro_torch.train.trainer``) on the CPU:
``tests/test_trainer.py``'s four trainer cases (runs and checkpoints;
survives an injected failure; a restart is an exact replay; the loss
falls on the synthetic stream), ``launch.train`` end to end, and tree
checkpoints moved both ways between the packages (the leaves' names are
the reference's ``keystr`` paths; arrays restored bit for bit)."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    CheckpointManager, latest_step, restore_checkpoint, restore_extra,
    save_checkpoint,
)
from repro_torch.configs import get_reduced
from repro_torch.data import DataConfig
from repro_torch.ft import FailureInjector
from repro_torch.launch import train as launch_train
from repro_torch.models.carry import (
    opt_state_from_numpy, params_from_numpy, tree_to_numpy,
)
from repro_torch.optim.quantized import init_opt_state_q8
from repro_torch.train.train_step import TrainHParams, init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils.tree import tree_flatten, tree_leaves


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small torch ops: on one thread each, since
    under the suite's parallel workers a pool of threads per op waits on
    the other workers' (restored after the module)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mk_trainer(tmp_path, *, steps=12, ckpt_every=4, injector=None, seed=0):
    """tests/test_trainer.py's settings, on the CPU."""
    cfg = get_reduced("internlm2-1.8b")
    hp = TrainHParams(lr=1e-3, warmup=2, total_steps=steps, remat=None,
                      ce_chunk=32)
    tc = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmp_path / "ckpts"), log_every=1000,
                       ckpt_async=True, seed=seed)
    data = DataConfig(kind="synthetic", vocab_size=cfg.vocab_size,
                      seq_len=32, global_batch=4)
    return Trainer(cfg, hp, tc, data, injector=injector,
                   log_fn=lambda *_: None, device="cpu")


def test_trainer_runs_and_checkpoints(tmp_path):
    out = _mk_trainer(tmp_path).run()
    assert out["step"] == 12
    assert len(out["history"]) == 12
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    ckpts = sorted((tmp_path / "ckpts").glob("step_*"))
    assert ckpts, "no checkpoint written"
    assert [c.name for c in ckpts] == ["step_000000004", "step_000000008",
                                       "step_000000012"]
    assert restore_extra(tmp_path / "ckpts", 12)["loss"] == \
        out["history"][-1]["loss"]


def test_trainer_survives_injected_failure(tmp_path):
    """Worker dies at step 9 -> restart from the step-8 checkpoint; the
    replayed history must end at the same step count with finite loss."""
    inj = FailureInjector(at_steps=[9])
    tr = _mk_trainer(tmp_path, injector=inj)
    out = tr.run()
    assert out["restarts"] == 1
    assert out["step"] == 12
    steps_seen = [h["step"] for h in out["history"]]
    assert steps_seen.count(9) == 1      # failed attempt raised BEFORE step 9 ran
    assert 8 in steps_seen


def test_restart_is_exact_replay(tmp_path):
    """An uninterrupted run and a failed and restarted run end with the
    same parameters and moments, bit for bit (stateless-by-step data,
    float32 checkpoints, the same operations in the same order)."""
    ref = _mk_trainer(tmp_path / "a", steps=8, ckpt_every=4).run()
    inj = FailureInjector(at_steps=[6])
    rec = _mk_trainer(tmp_path / "b", steps=8, ckpt_every=4,
                      injector=inj).run()
    assert rec["restarts"] == 1
    for a, b in zip(tree_leaves([ref["params"], ref["opt"]]),
                    tree_leaves([rec["params"], rec["opt"]])):
        assert torch.equal(a, b)
    assert [h["loss"] for h in rec["history"] if h["step"] >= 4][-4:] == \
        [h["loss"] for h in ref["history"]][4:]


def test_trainer_loss_decreases_on_synthetic(tmp_path):
    out = _mk_trainer(tmp_path, steps=30, ckpt_every=100).run()
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first, (first, last)


def test_launch_train_on_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "internlm2-1.8b", "--steps", "3",
                             "--device", "cpu", "--seq-len", "16",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert out["step"] == 3 and out["restarts"] == 0
    assert "done: step=3" in capsys.readouterr().out
    assert latest_step(tmp_path / "ck") == 3
    # the RegC path runs (one process without torch.distributed.run's
    # environment); its sync options, ignored by one process, raise
    # on the default path, naming the regc path where they apply
    out = launch_train.main(["--path", "regc", "--device", "cpu", "--steps",
                             "2", "--seq-len", "16", "--ckpt-dir",
                             str(tmp_path / "regc")])
    assert out["step"] == 2 and latest_step(tmp_path / "regc") == 2
    for flag, value in (("--sync-compression", "int8_ring"),
                        ("--sync-granularity", "object")):
        with pytest.raises(NotImplementedError, match="regc"):
            launch_train.main([flag, value, "--device", "cpu", "--ckpt-dir",
                               str(tmp_path / "refused")])
    assert not (tmp_path / "refused").exists()


# ---------------------------------------------------------------------------
# tree checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_state():
    """A reduced jamba's parameters (eight blocks of a pattern, MoE and
    SSD leaves) and AdamW moments as the reference's pytree of arrays."""
    jax = pytest.importorskip("jax")
    cfg = get_reduced("jamba-1.5-large-398b")
    params, _ = init_train_state(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    params = jax.tree.map(jax.numpy.asarray, tree_to_numpy(params))
    opt = {k: jax.tree.map(lambda a: a + 0.25 * (i + 1), params)
           for i, k in enumerate(("m", "v"))}
    return jax, cfg, {"params": params, "opt": opt}


def test_reference_checkpoint_restores_in_port(tmp_path, ref_state):
    jax, cfg, tree = ref_state
    from repro.checkpoint import CheckpointManager as RefManager
    RefManager(tmp_path, async_write=False).save(5, tree,
                                                 extra={"loss": 1.5})
    host = jax.device_get(tree)
    template = {"params": params_from_numpy(cfg, host["params"], "cpu"),
                "opt": opt_state_from_numpy(cfg, host["opt"], "cpu")}
    template = {k: jax.tree.map(torch.zeros_like, v)
                for k, v in template.items()}
    got = CheckpointManager(tmp_path).restore(5, template)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(host)[0]]
    assert [k for k, _ in tree_flatten(got)] == paths
    for a, b in zip(tree_leaves(got), jax.tree.leaves(host)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert restore_extra(tmp_path, 5) == {"loss": 1.5}


def test_port_checkpoint_restores_in_reference(tmp_path, ref_state):
    jax, cfg, tree = ref_state
    from repro.checkpoint.store import restore_checkpoint as ref_restore
    from repro.checkpoint.store import restore_extra as ref_extra
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(4),
                                   device="cpu")
    opt = {"m": opt["m"], "v": init_opt_state_q8(params)}
    state = {"params": params, "opt": opt}
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(7, state, extra={"step": 7})
    mgr.wait()
    host = tree_to_numpy(state)
    template = jax.tree.map(np.zeros_like, host)
    got = ref_restore(tmp_path, 7, template)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(host)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert ref_extra(tmp_path, 7) == {"step": 7}
    # and back into the port, with a template on another dtype
    back = restore_checkpoint(tmp_path, 7, state)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)
    save_checkpoint(tmp_path, 8, {"w": torch.ones(3)}, blocking=False).join()
    with pytest.raises(ValueError, match="no leaf"):
        restore_checkpoint(tmp_path, 8, {"v": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 8, {"w": torch.ones(4)})
