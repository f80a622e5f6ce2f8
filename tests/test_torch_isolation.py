"""Isolation and entry-point rules of the port:

* no file under ``src/repro_torch/``, nor ``chip_smoke.py``,
  ``rank_select_probe.py`` or ``sp_probe.py``, imports ``jax`` or
  anything of ``repro``
  (AST scan);
* ``repro_torch`` imports and runs a small CPU trace in a process where
  ``import jax`` fails, and there ``repro_torch.cluster`` imports and
  composes the trace's two shard slices into a snapshot that restores,
  and a reduced model takes a train step;
* entry points run on the card by default and raise without one (the
  training ones too: ``Trainer``, ``init_train_state``,
  ``make_pipeline``, ``launch.train``); the explicit RegC train path
  builds and takes a step in one process, so does a sharding context
  (equal, on a mesh of one rank, to the one-process step bit for bit),
  under every rules table, with either optimiser and SSM layers too
  (ROADMAP item 13g), where ``import jax`` fails; the serving entry
  points take a ``ctx`` where ``import jax`` fails;
* the knobs of ported slices (race detection and the recovery hooks
  among them, and the reference engine) build a runtime, and the
  reference engine raises on the recovery hooks, naming the slice;
* ``chip_smoke.py`` fails, printing no result, without a card and in a
  directory that holds nothing else of the repo."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import RegionDirectory, RuntimeConfig, make_runtime
from repro_torch.dsm.costmodel import ChaosNet
from repro_torch.ft import FailureInjector, StragglerMonitor

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "rank_select_probe.py",
    ROOT / "sp_probe.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_runs_without_jax(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import make_runtime\n"
        "from repro_torch.dsm import apps\n"
        "rt = make_runtime(4, protocol='page', device='cpu')\n"
        "apps.jacobi(rt, 32, 2, mode='lock')\n"
        "assert rt.traffic.page_fetches > 0 and rt.time > 0\n"
        "from repro_torch.cluster import ClusterRuntime, state_digest\n"
        "from repro_torch.core import RegCScaleRuntime\n"
        "full = RegCScaleRuntime.compose_snapshots(\n"
        "    [rt.snapshot(rows=(0, 1)), rt.snapshot(rows=(1, 4))])\n"
        "again = RegCScaleRuntime.from_snapshot(*full, device='cpu')\n"
        "assert state_digest(again) == state_digest(rt)\n"
        "import torch\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.train.train_step import (TrainHParams,\n"
        "    init_train_state, make_train_step)\n"
        "from repro_torch.data import DataConfig, make_pipeline\n"
        "cfg = get_reduced('internlm2-1.8b')\n"
        "p, opt = init_train_state(cfg, torch.Generator().manual_seed(0),\n"
        "                          device='cpu')\n"
        "pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,\n"
        "    seq_len=16, global_batch=2), device='cpu')\n"
        "step, batch = next(pipe)\n"
        "pipe.close()\n"
        "p2, opt2, m = make_train_step(cfg, TrainHParams(ce_chunk=16))(\n"
        "    p, opt, batch, step)\n"
        "assert torch.isfinite(m['loss']) and float(m['grad_norm']) > 0\n"
        "assert not torch.equal(p2['embed'], p['embed'])\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "from repro_torch.launch.ranks import init_world\n"
        "from repro_torch.regc_sync import RegCSyncPolicy\n"
        "from repro_torch.train.train_step import make_train_step_regc\n"
        "assert init_world('gloo')\n"
        "hp = TrainHParams(ce_chunk=16, sync=RegCSyncPolicy(\n"
        "    granularity='object', compression='int8_ring'))\n"
        "step_fn = make_train_step_regc(cfg, hp, make_host_mesh((1,), ('data',)))\n"
        "p3, _, m3 = step_fn(p, opt, batch, step)\n"
        "assert torch.equal(m3['loss'], m['loss'])\n"
        "assert all(torch.equal(a, b) for a, b in zip(\n"
        "    p2.values(), p3.values()) if torch.is_tensor(a))\n"
        "from repro_torch.models.sharding import DEFAULT_RULES, ShardingCtx\n"
        "from repro_torch.train.train_step import shard_state\n"
        "from repro_torch.utils.tree import tree_leaves\n"
        "ctx = ShardingCtx(make_host_mesh((1, 1), ('data', 'model')),\n"
        "                  DEFAULT_RULES)\n"
        "lp, lo = shard_state(cfg, ctx, p, opt)\n"
        "p4, _, m4 = make_train_step(cfg, TrainHParams(ce_chunk=16), ctx)(\n"
        "    lp, lo, batch, step)\n"
        "assert torch.equal(m4['loss'], m['loss'])\n"
        "assert all(torch.equal(a, b) for a, b in zip(\n"
        "    tree_leaves(p2), tree_leaves(p4)))\n"
        "import torch.distributed as dist\n"
        "dist.destroy_process_group()\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_training_under_every_table_runs_without_jax(tmp_path):
    """The training paths of ROADMAP item 13g (the seq_sp boundary, SSM
    layers in a sharded step, ``adamw8bit`` under a ctx, the serving
    tables and ``gather_fsdp=False``) import and run where ``import
    jax`` fails: on a one-rank mesh, under every table of
    ``NAMED_RULES`` with the ``gather_fsdp`` the reference pairs it with
    and ``DEFAULT_RULES`` with ``gather_fsdp=False``, attention, SSM and
    hybrid configs take a step with AdamW and ``adamw8bit`` equal to the
    one-process step bit for bit, and ``eval_loss(ctx=)`` gives its
    loss."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "from repro_torch.launch.ranks import init_world\n"
        "from repro_torch.models import sharding as SH\n"
        "from repro_torch.optim.adamw import init_opt_state\n"
        "from repro_torch.optim.quantized import init_opt_state_q8\n"
        "from repro_torch.train import train_step as T\n"
        "from repro_torch.utils.tree import tree_leaves\n"
        "torch.set_num_threads(1)\n"
        "assert init_world('gloo')\n"
        "mesh = make_host_mesh((1, 1), ('data', 'model'))\n"
        "g = torch.Generator().manual_seed(1)\n"
        "batch = {k: torch.randint(0, 256, (2, 32), generator=g)\n"
        "         for k in ('tokens', 'targets')}\n"
        "tables = [(r, r not in (SH.DECODE_2D_RULES, SH.LONG_2D_RULES))\n"
        "          for r in SH.NAMED_RULES.values() if r is not None]\n"
        "tables += [(SH.DEFAULT_RULES, True), (SH.DEFAULT_RULES, False)]\n"
        "for arch in ('internlm2-1.8b', 'mamba2-2.7b', "
        "'jamba-1.5-large-398b'):\n"
        "    cfg = get_reduced(arch)\n"
        "    p, _ = T.init_train_state(cfg, torch.Generator().manual_seed(0),"
        "\n"
        "                              device='cpu')\n"
        "    for opt_impl, init in (('adamw', init_opt_state),\n"
        "                           ('adamw8bit', init_opt_state_q8)):\n"
        "        hp = T.TrainHParams(ce_chunk=16, remat=None, "
        "opt_impl=opt_impl)\n"
        "        p1, o1, m1 = T.make_train_step(cfg, hp)(p, init(p), batch, 0)"
        "\n"
        "        for rules, gf in tables:\n"
        "            ctx = SH.ShardingCtx(mesh, rules, gather_fsdp=gf)\n"
        "            lp, lo = T.shard_state(cfg, ctx, p, init(p))\n"
        "            p2, o2, m2 = T.make_train_step(cfg, hp, ctx)(\n"
        "                lp, lo, batch, 0)\n"
        "            assert torch.equal(m2['loss'], m1['loss']), (arch, "
        "rules)\n"
        "            assert all(torch.equal(a, b) for a, b in zip(\n"
        "                tree_leaves([p1, o1]), tree_leaves([p2, o2]))), "
        "(arch, rules)\n"
        "            l2, _ = T.eval_loss(cfg, hp, lp, batch, ctx)\n"
        "            assert torch.equal(l2, m1['loss']), (arch, rules)\n"
        "dist.destroy_process_group()\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_serving_under_a_ctx_runs_without_jax(tmp_path):
    """The serving entry points with ``ctx=`` import and run where
    ``import jax`` fails: on a one-rank mesh, under every serving table,
    ``generate``, ``make_prefill_step`` and ``make_serve_step`` give the
    one-process port's tokens and logits bit for bit."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "from repro_torch.launch.ranks import init_world\n"
        "from repro_torch.models import sharding as SH\n"
        "from repro_torch.models.model import init_model_params, "
        "param_specs\n"
        "from repro_torch.serve.decode import (generate, make_prefill_step,\n"
        "                                      make_serve_step)\n"
        "assert init_world('gloo')\n"
        "mesh = make_host_mesh((1, 1), ('data', 'model'))\n"
        "prompt = {'tokens': torch.arange(8, dtype=torch.int32)"
        ".reshape(2, 4)}\n"
        "for arch in ('internlm2-1.8b', 'mamba2-2.7b'):\n"
        "    cfg = get_reduced(arch)\n"
        "    p = init_model_params(cfg, device='cpu')\n"
        "    want = generate(cfg, p, prompt, max_new_tokens=3, device='cpu')\n"
        "    l0, c0 = make_prefill_step(cfg, max_len=8)(p, prompt)\n"
        "    for rules, gf in (('SERVE_RULES', True), ('SMALL_SERVE_RULES', "
        "True),\n"
        "                      ('LONG_CONTEXT_RULES', True), "
        "('DECODE_2D_RULES', False),\n"
        "                      ('LONG_2D_RULES', False)):\n"
        "        ctx = SH.ShardingCtx(mesh, getattr(SH, rules), "
        "gather_fsdp=gf)\n"
        "        lp = SH.shard_params(p, ctx, SH.param_shardings(\n"
        "            param_specs(cfg), ctx))\n"
        "        got = generate(cfg, lp, prompt, max_new_tokens=3, ctx=ctx,\n"
        "                       device='cpu')\n"
        "        assert torch.equal(got, want), (arch, rules)\n"
        "        l1, c1 = make_prefill_step(cfg, ctx, max_len=8)(lp, prompt)\n"
        "        assert torch.equal(l1, l0), (arch, rules)\n"
        "        t0, _, _ = make_serve_step(cfg)(p, {'tokens': want[:, :1]},"
        " c0, 4)\n"
        "        t1, _, _ = make_serve_step(cfg, ctx)(lp, {'tokens': "
        "want[:, :1]}, c1, 4)\n"
        "        assert torch.equal(t0, t1), (arch, rules)\n"
        "dist.destroy_process_group()\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert make_runtime(4).device.type == "cuda"
        with pytest.raises(ValueError, match="CPU-only"):
            make_runtime(4, backend="plain")
        return
    # no card: the default entry point raises instead of running on CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_runtime(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_runtime(4, device="cuda")
    assert make_runtime(4, device="cpu").device.type == "cpu"


def test_directory_default_device_is_the_card():
    if torch.cuda.is_available():
        assert RegionDirectory(4, 0, 0, 64).device.type == "cuda"
        return
    # built on its own, a directory raises too rather than running on CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RegionDirectory(4, 0, 0, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RegionDirectory(4, 0, 0, 64, backend="kernels", device="cuda")
    d = RegionDirectory(4, 0, 0, 64, device="cpu")
    assert d.device.type == "cpu" and d.valid.device.type == "cpu"


@pytest.mark.parametrize("knob,value", [("cache_pages", 8),
                                        ("danger_mode", "scalar")])
def test_slice_b_knobs_build_a_runtime(knob, value):
    """Eviction (slice B) is ported: its knobs reach the runtime."""
    rt = make_runtime(4, device="cpu", **{knob: value})
    assert getattr(rt, knob) == value
    ga = rt.alloc(64 * 1024)
    rt.phase_all(reads=[(ga, 0, 64 * 1024)])
    rt.barrier()
    assert rt.traffic.page_fetches > 0
    if knob == "cache_pages":
        assert (rt.resident <= value).all() and rt.resident.max() == value


def test_detect_races_builds_a_detecting_runtime():
    """Race detection (slice E) is ported: the knob reaches the scale
    engine, which flags an unordered write/write pair."""
    rt = make_runtime(4, device="cpu", detect_races=True, page_words=16)
    assert type(rt).__name__ == "RegCScaleRuntime" and rt.detect_races
    ga = rt.alloc(64)
    rt.phase_all(writes=[(ga, 0, 8)])
    rt.barrier()
    assert len(rt.races) == 6 and rt.race_counts["race_ww"] == 6


@pytest.mark.parametrize("knob,value,slice_name", [
    ("chaos", ChaosNet(seed=3), "recovery"),
    ("injector", FailureInjector(at_steps=[2]), "recovery"),
    ("straggler", StragglerMonitor(4), "recovery")])
def test_later_slice_knobs_raise(knob, value, slice_name):
    """The recovery slice's knobs, refused by name until that slice was
    ported, now build a scale runtime that carries them; the per-page
    reference engine still raises on them, naming the slice, as the
    reference package's does."""
    rt = make_runtime(4, device="cpu", **{knob: value})
    assert type(rt).__name__ == "RegCScaleRuntime"
    assert getattr(rt, knob) is value
    with pytest.raises(ValueError, match=f"{knob}.*{slice_name}"):
        make_runtime(4, engine="reference", device="cpu", **{knob: value})


def test_config_validation():
    # the per-page reference engine (slice C) builds on the CPU on request
    rt = make_runtime(4, engine="reference", device="cpu")
    assert type(rt).__name__ == "RegCRuntime" and rt.device.type == "cpu"
    assert rt.track_values and rt.home is None
    with pytest.raises(ValueError, match="allowed"):
        make_runtime(4, engine="magic", device="cpu")
    with pytest.raises(ValueError, match="unknown RuntimeConfig override"):
        make_runtime(4, device="cpu", cache_size=3)
    with pytest.raises(ValueError, match="'numpy'"):
        RuntimeConfig(backend="numpy")
    with pytest.raises(ValueError, match="protocol"):
        RuntimeConfig(protocol="mesi")
    cfg = RuntimeConfig(protocol="page", fetch_batch=16, device="cpu")
    rt = make_runtime(8, cfg, backend="kernels")
    assert (rt.protocol, rt.fetch_batch, rt.backend) == ("page", 16,
                                                         "kernels")


def test_model_entry_points_default_to_the_card():
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_model_params
    from repro_torch.serve.decode import generate
    cfg = get_reduced("internlm2-1.8b")
    params = init_model_params(cfg, device="cpu")
    prompt = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if torch.cuda.is_available():
        assert init_model_params(cfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cfg, params, prompt, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, params, [prompt["tokens"][0].numpy()], batch=1, max_new=2)
    out = generate(cfg, params, prompt, max_new_tokens=2, device="cpu")
    assert out.shape == (1, 2) and out.device.type == "cpu"


def test_train_entry_points_default_to_the_card(tmp_path):
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_step import TrainHParams, init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_reduced("internlm2-1.8b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    tc = TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path / "ck"))
    if torch.cuda.is_available():
        p, _ = init_train_state(cfg)
        assert p["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipeline(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainHParams(), tc, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1", "--ckpt-dir",
                           str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_regc_train_path_raises_naming_13d(tmp_path):
    """ROADMAP items 13d, 13e and 13g are ported: the RegC path builds
    (its Trainer needs a mesh) and so do sharding contexts under every
    rules table (an ``inner_ctx`` whose rules name no dp axis too),
    ``gather_fsdp=False``, SSM layers and ``adamw8bit`` under a ctx, the
    step and the Trainer (in a world of one rank).  What still raises,
    before a checkpoint directory is made: the reference's two refusals
    of an ``inner_ctx`` (a rule on a dp axis; ``moe_impl='ep'``) and, on
    the one-process path, every sync policy but the default (which it
    would ignore), naming the regc path where the policy applies."""
    import torch.distributed as dist
    from repro_torch.launch.ranks import init_world
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.models import sharding as SH
    from repro_torch.regc_sync.policies import RegCSyncPolicy
    from repro_torch.train.train_step import (TrainHParams, make_train_step,
                                              make_train_step_regc)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_reduced("internlm2-1.8b")

    class Shape:            # a mesh's axis sizes, no ranks
        shape = {"data": 2, "model": 4}
    mesh = Shape()
    for rules in (SH.DEFAULT_RULES, SH.SMALL_MODEL_RULES, SH.FSDP_POD_RULES):
        for impl in SH.MOE_IMPLS:
            assert callable(make_train_step(cfg, TrainHParams(),
                                            SH.ShardingCtx(mesh, rules,
                                                           moe_impl=impl)))
    arch = "internlm2-1.8b"
    for ctx, hp, arch in (
            (SH.ShardingCtx(mesh, SH.SERVE_RULES), TrainHParams(), arch),
            (SH.ShardingCtx(mesh, SH.DECODE_2D_RULES, gather_fsdp=False),
             TrainHParams(), arch),
            (SH.ShardingCtx(mesh, SH.TRAIN_SP_RULES), TrainHParams(), arch),
            (SH.ShardingCtx(mesh, SH.DEFAULT_RULES, gather_fsdp=False),
             TrainHParams(), arch),
            (SH.ShardingCtx(mesh, SH.DEFAULT_RULES),
             TrainHParams(opt_impl="adamw8bit"), arch),
            (SH.ShardingCtx(mesh, SH.DEFAULT_RULES), TrainHParams(),
             "mamba2-2.7b")):
        assert callable(make_train_step(get_reduced(arch), hp, ctx))
        owned = init_world("gloo")
        try:
            tr = Trainer(get_reduced(arch), hp, TrainerConfig(
                ckpt_dir=str(tmp_path / "built")), DataConfig(), ctx=ctx,
                device="cpu")
            assert tr.ctx is ctx and callable(tr.step_fn)
        finally:
            if owned:
                dist.destroy_process_group()
    with pytest.raises(ValueError, match="manual axes"):
        make_train_step_regc(cfg, TrainHParams(), mesh,
                             inner_ctx=SH.ShardingCtx(mesh, SH.DEFAULT_RULES))
    with pytest.raises(ValueError, match="shard_map"):
        make_train_step_regc(cfg, TrainHParams(), mesh, inner_ctx=(
            SH.ShardingCtx(mesh, dict(SH.DEFAULT_RULES, batch=None,
                                      embed_fsdp=None), moe_impl="ep")))
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(cfg, TrainHParams(), TrainerConfig(
            path="regc", ckpt_dir=str(tmp_path / "ck")), DataConfig(),
            device="cpu")
    for sync in (RegCSyncPolicy(compression="int8_ring"),
                 RegCSyncPolicy(granularity="object"),
                 RegCSyncPolicy(ordinary_sync="eager")):
        hp = TrainHParams(sync=sync)
        with pytest.raises(NotImplementedError, match="regc"):
            make_train_step(cfg, hp)
        with pytest.raises(NotImplementedError, match="regc"):
            Trainer(cfg, hp, TrainerConfig(ckpt_dir=str(tmp_path / "ck")),
                    DataConfig(), device="cpu")
    assert not (tmp_path / "ck").exists()


def _smoke(cwd: Path, script: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    out = _smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = _smoke(tmp_path, lone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
