"""The port's serving under a sharding context (``make_prefill_step``,
``decode_step``, ``make_serve_step`` and ``generate`` with ``ctx=``) on
8 gloo ranks of the CPU, against the reference's GSPMD serving.

One JAX subprocess with 8 host devices (as ``tests/test_variants.py``
runs ``DECODE2D_SCRIPT`` and ``HYBRID_2D_SCRIPT``) writes, for each
case, the parameters (``PRNGKey(0)``), the prompt (B x 16 tokens, or
N(0, 1) embeddings with (3, B, S) M-RoPE positions of distinct t/h/w
axes, from ``PRNGKey(1)``) and three decode inputs; then the reference's
jitted ``make_prefill_step(cfg, ctx, max_len=32)`` (float32 caches), its
first-token logits and caches, three ``decode_step(ctx)`` logits, the
caches after them, and ``generate(ctx=)``'s 4 greedy tokens.  MoE
configs run at ``capacity_factor=4.0`` (nothing drops, so the dispatch
groups of a sharding cannot change a value), as ``HYBRID_2D_SCRIPT``
runs jamba.  The cases, on mesh (2, 4) ``("data", "model")`` with B = 4
unless noted: llama3-405b under ``SERVE_RULES`` and ``DECODE_2D_RULES``
(``gather_fsdp=False``), and under ``DEFAULT_RULES`` and
``TRAIN_SP_RULES``; jamba-1.5-large-398b (SSD, attention and MoE) under
``SERVE_RULES`` and ``DECODE_2D_RULES``; internlm2-1.8b (q heads split,
kv heads whole) and mamba2-2.7b (SSM only) under ``SMALL_SERVE_RULES``;
gemma2-27b under ``DECODE_2D_RULES`` (tied embedding, softcaps, a local
window across cache blocks); qwen2-vl-72b under ``SERVE_RULES``
(``embeds``, M-RoPE); moonshot-v1-16b-a3b with ``moe_impl='ep'`` under
``SERVE_RULES`` and ``DECODE_2D_RULES`` (the reference serves it); and
llama3-405b at B = 1 on mesh (2, 2, 2) ``("pod", "data", "model")``
under ``LONG_CONTEXT_RULES`` (also with ``gather_fsdp=False``: whole
activations against weights whose d_model stays split over 'data') and
``LONG_2D_RULES`` (positions split 8 ways); musicgen-medium
(``embeds``: each decode step's embedding a vocab-parallel lookup)
under ``DECODE_2D_RULES``.  ``FUZZ_TORCH=1`` adds musicgen under
``SERVE_RULES`` and ``LONG_2D_RULES``, qwen2-vl under
``DECODE_2D_RULES`` and ``LONG_CONTEXT_RULES``, granite-20b and
grok-1-314b under ``DECODE_2D_RULES`` and mamba2 under
``LONG_2D_RULES`` (no attention layer: no softmax combine).

Eight spawned gloo ranks run the port, each on its blocks of the same
parameters.  Checked: logits within the reference's own tolerances
(rtol/atol 2e-4; 5e-4 for the MoE cases) and within 1e-4 of the port's
one-process run; greedy tokens equal to the reference's but for counted
near ties (1e-4 of the logits along the reference's path); caches after
prefill and after the last decode, gathered to the reference's layout,
within 1e-5, and a rank's blocks of them back from the gathered ones
(``shard_caches``) bit for bit; every rank's logits and tokens
bit-equal; the KV cache's
spec splitting ``kv_seq`` where the rules map it; and under the
no-regather tables no parameter gathered, a decode token moving only
activation rows.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import collectives as C
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.models.model import param_specs
from repro_torch.serve.decode import generate, make_prefill_step
from repro_torch.utils.tree import tree_flatten, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
FUZZ = os.environ.get("FUZZ_TORCH") == "1"

WORLD = 8
S, MAX_LEN, NEW = 16, 32, 4
ONE_TOL = 1e-4
CACHE_TOL = 1e-5
TIE_TOL = 1e-4
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (tag, arch, mesh, rules, gather_fsdp, moe_impl, B)
CASES = (
    ("llama_serve", "llama3-405b", "2x4", "SERVE_RULES", True, "dense", 4),
    ("llama_2d", "llama3-405b", "2x4", "DECODE_2D_RULES", False, "dense",
     4),
    ("jamba_serve", "jamba-1.5-large-398b", "2x4", "SERVE_RULES", True,
     "dense", 4),
    ("jamba_2d", "jamba-1.5-large-398b", "2x4", "DECODE_2D_RULES", False,
     "dense", 4),
    ("internlm2_small", "internlm2-1.8b", "2x4", "SMALL_SERVE_RULES", True,
     "dense", 4),
    ("mamba2_small", "mamba2-2.7b", "2x4", "SMALL_SERVE_RULES", True,
     "dense", 4),
    ("gemma2_2d", "gemma2-27b", "2x4", "DECODE_2D_RULES", False, "dense",
     4),
    ("qwen2_vl_serve", "qwen2-vl-72b", "2x4", "SERVE_RULES", True, "dense",
     4),
    ("moonshot_ep", "moonshot-v1-16b-a3b", "2x4", "SERVE_RULES", True, "ep",
     4),
    ("moonshot_ep_2d", "moonshot-v1-16b-a3b", "2x4", "DECODE_2D_RULES",
     False, "ep", 4),
    ("llama_default", "llama3-405b", "2x4", "DEFAULT_RULES", True, "dense",
     4),
    ("llama_train_sp", "llama3-405b", "2x4", "TRAIN_SP_RULES", True,
     "dense", 4),
    ("llama_long", "llama3-405b", "2x2x2", "LONG_CONTEXT_RULES", True,
     "dense", 1),
    ("llama_long_2d", "llama3-405b", "2x2x2", "LONG_2D_RULES", False,
     "dense", 1),
    ("llama_long_split_weights", "llama3-405b", "2x2x2",
     "LONG_CONTEXT_RULES", False, "dense", 1),
    ("musicgen_2d", "musicgen-medium", "2x4", "DECODE_2D_RULES", False,
     "dense", 4),
) + ((
    ("musicgen_serve", "musicgen-medium", "2x4", "SERVE_RULES", True,
     "dense", 4),
    ("musicgen_long_2d", "musicgen-medium", "2x2x2", "LONG_2D_RULES", False,
     "dense", 1),
    ("qwen2_vl_2d", "qwen2-vl-72b", "2x4", "DECODE_2D_RULES", False, "dense",
     4),
    ("qwen2_vl_long", "qwen2-vl-72b", "2x2x2", "LONG_CONTEXT_RULES", True,
     "dense", 1),
    ("granite_2d", "granite-20b", "2x4", "DECODE_2D_RULES", False, "dense",
     4),
    ("grok_2d", "grok-1-314b", "2x4", "DECODE_2D_RULES", False, "dense", 4),
    ("mamba2_long_2d", "mamba2-2.7b", "2x2x2", "LONG_2D_RULES", False,
     "dense", 1),
) if FUZZ else ())
NO_REGATHER = ("DECODE_2D_RULES", "LONG_2D_RULES")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


REF_SCRIPT = r"""
import dataclasses
import functools
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_reduced
from repro.models import model as M
from repro.models import sharding as SH
from repro.serve.decode import generate, make_prefill_step

out_path, spec = sys.argv[1], eval(sys.argv[2])
S, MAX_LEN, NEW = spec["S"], spec["max_len"], spec["new"]
res = {}
meshes = {k: make_mesh(shape, axes) for k, (shape, axes) in
          spec["meshes"].items()}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


for tag, arch, mesh_key, rules, gf, impl, B in spec["cases"]:
    cfg = get_reduced(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    params = M.init_model_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    if cfg.input_mode == "embeds":
        prompt = {"embeds": jax.random.normal(ks[0], (B, S, cfg.d_model))}
        steps = jax.random.normal(ks[1], (3, B, 1, cfg.d_model))
    else:
        prompt = {"tokens": jax.random.randint(ks[0], (B, S), 0,
                                               cfg.vocab_size)}
        steps = jax.random.randint(ks[1], (3, B, 1), 0, cfg.vocab_size)
    if cfg.mrope:
        i = np.arange(S - 4)
        grid = np.stack([np.r_[np.arange(4), np.full(i.size, 4)],
                         np.r_[np.arange(4), 4 + i // 4],
                         np.r_[np.arange(4), 4 + i % 4]])
        pos = grid[:, None, :] + np.arange(B)[None, :, None]
        prompt["positions"] = jnp.asarray(pos.astype(np.int32))
    put(f"{tag}/in/params", params)
    res.update({f"{tag}/in/prompt/{k}": np.asarray(v)
                for k, v in prompt.items()})
    res[f"{tag}/in/steps"] = np.asarray(steps)
    ctx = SH.ShardingCtx(mesh=meshes[mesh_key], rules=getattr(SH, rules),
                         gather_fsdp=gf, moe_impl=impl)
    logits, caches = jax.jit(make_prefill_step(
        cfg, ctx, max_len=MAX_LEN, cache_dtype=jnp.float32))(params, prompt)
    res[f"{tag}/prefill"] = np.asarray(logits)
    put(f"{tag}/caches_prefill", caches)
    dec = jax.jit(functools.partial(M.decode_step, cfg, ctx=ctx))
    key = "embeds" if cfg.input_mode == "embeds" else "tokens"
    for j in range(3):
        batch = {key: steps[j]}
        if cfg.mrope:
            batch["positions"] = jnp.full((3, B, 1), S + j + 7, jnp.int32)
        logits, caches = dec(params, batch, caches, jnp.asarray(S + j))
        res[f"{tag}/decode{j}"] = np.asarray(logits)
    put(f"{tag}/caches_decode", caches)
    res[f"{tag}/tokens"] = np.asarray(generate(
        cfg, params, prompt, max_new_tokens=NEW, ctx=ctx))
np.savez(out_path, **res)
print("REF_OK")
"""


def run_reference(out: Path, spec) -> dict:
    """REF_SCRIPT on 8 host devices, at LLVM optimisation level 0 (the
    programs XLA partitions and runs are the same, compiled faster)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                           repr(spec)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _case(tag):
    return next(c for c in CASES if c[0] == tag)


def _cfg(arch):
    cfg = get_reduced(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    return cfg


def _params(cfg, ref, tag):
    spec = param_specs(cfg)
    pre = f"{tag}/in/params"
    return tree_unflatten(spec, [torch.from_numpy(np.array(ref[pre + k]))
                                 for k, _ in tree_flatten(spec)])


def _prompt(ref, tag):
    pre = f"{tag}/in/prompt/"
    return {k[len(pre):]: torch.from_numpy(np.array(v))
            for k, v in ref.items() if k.startswith(pre)}


def _step(cfg, ref, tag, j, B):
    x = torch.from_numpy(np.array(ref[f"{tag}/in/steps"][j]))
    batch = {"embeds" if cfg.input_mode == "embeds" else "tokens": x}
    if cfg.mrope:
        batch["positions"] = torch.full((3, B, 1), S + j + 7,
                                        dtype=torch.int32)
    return batch


def _cache_arrays(caches):
    return [np.array(t.detach().numpy()) for pair in caches for t in pair]


def _pairs(cfg, arrays):
    """``_cache_arrays``' flat list back as one pair a pattern position."""
    return [(torch.from_numpy(arrays[2 * i]),
             torch.from_numpy(arrays[2 * i + 1]))
            for i in range(len(cfg.pattern))]


def _flat_pairs(caches):
    return [t for pair in caches for t in pair]


def serve(cfg, params, ref, tag, B, ctx, on_last_decode=None):
    """The case's prefill, three decode steps and generate: logits,
    caches (gathered under ``ctx``) after prefill and after the last
    step, tokens.  ``on_last_decode`` (before, after) brackets the last
    decode step."""
    prompt = _prompt(ref, tag)
    out = {}
    logits, caches = make_prefill_step(cfg, ctx, max_len=MAX_LEN,
                                       cache_dtype=torch.float32)(
        params, prompt)
    out["prefill"] = logits.numpy()

    def full(c):
        return _cache_arrays(c if ctx is None else
                             SH.gather_caches(cfg, ctx, c, B))
    out["caches_prefill"] = full(caches)
    for j in range(3):
        if j == 2 and on_last_decode:
            on_last_decode[0]()
        logits, caches = M.decode_step(cfg, params, _step(cfg, ref, tag, j, B),
                                       caches, S + j, ctx)
        if j == 2 and on_last_decode:
            on_last_decode[1]()
        out[f"decode{j}"] = logits.numpy()
    out["caches_decode"] = full(caches)
    if ctx is not None:
        out["caches_decode_local"] = _cache_arrays(caches)
    out["tokens"] = generate(cfg, params, prompt, max_new_tokens=NEW,
                             ctx=ctx, device="cpu").numpy()
    return out


def serve_rank(ref_path: str, cases):
    """One rank: every case's serving from the reference's parameters,
    each rank on its blocks."""
    with np.load(ref_path) as z:
        ref = dict(z)
    meshes = {k: make_host_mesh(*v) for k, v in MESHES.items()}
    results = {}
    for tag, arch, mesh_key, rules, gf, impl, B in cases:
        cfg = _cfg(arch)
        ctx = SH.ShardingCtx(meshes[mesh_key], getattr(SH, rules),
                             gather_fsdp=gf, moe_impl=impl)
        full = _params(cfg, ref, tag)
        params = SH.shard_params(full, ctx,
                                 SH.param_shardings(param_specs(cfg), ctx))
        decode, gathers = {}, [0]

        def before():
            gathers[0] += C.PARAM_GATHERS["messages"]
            C.reset_collectives()

        def after():
            decode["msgs"] = dict(C.COLLECTIVE_MSGS)
        C.reset_collectives()
        with torch.no_grad():
            row = serve(cfg, params, ref, tag, B, ctx, (before, after))
        row["decode_msgs"] = decode["msgs"]
        row["param_gathers"] = gathers[0] + C.PARAM_GATHERS["messages"]
        row["cache_specs"] = SH.cache_specs(cfg, ctx, B, MAX_LEN)
        row["blocks_roundtrip"] = all(
            np.array_equal(a.numpy(), b) for a, b in zip(
                _flat_pairs(SH.shard_caches(
                    cfg, ctx, _pairs(cfg, row["caches_decode"]), MAX_LEN)),
                row["caches_decode_local"]))
        results[tag] = row
    return results


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    ref = run_reference(tmp / "ref.npz", {
        "S": S, "max_len": MAX_LEN, "new": NEW, "meshes": MESHES,
        "cases": list(CASES)})
    got = spawn_ranks(WORLD, "test_torch_tp_serve:serve_rank",
                      (str(tmp / "ref.npz"), CASES), backend="gloo",
                      init_method=f"file://{tmp / 'store'}", timeout_s=300)
    return ref, got


@pytest.fixture(scope="module")
def one_process(served):
    """The port's one-process serving of every case, on the same
    parameters and inputs."""
    ref, _ = served
    out = {}
    with torch.no_grad():
        for tag, arch, *_, B in CASES:
            cfg = _cfg(arch)
            out[tag] = serve(cfg, _params(cfg, ref, tag), ref, tag, B, None)
    return out


def _ref_tol(arch):
    return 5e-4 if _cfg(arch).moe is not None else 2e-4


LOGITS = ("prefill", "decode0", "decode1", "decode2")


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_sharded_logits_match_reference(served, tag):
    ref, got = served
    tol = _ref_tol(_case(tag)[1])
    for k in LOGITS:
        np.testing.assert_allclose(got[0][tag][k], ref[f"{tag}/{k}"],
                                   rtol=tol, atol=tol, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_sharded_logits_match_one_process(served, one_process, tag):
    _, got = served
    for k in LOGITS:
        np.testing.assert_allclose(got[0][tag][k], one_process[tag][k],
                                   rtol=ONE_TOL, atol=ONE_TOL,
                                   err_msg=f"{tag} {k}")


def _near_ties(cfg, params, ref, tag, B, want, got):
    """Rows of ``got`` equal to ``want`` up to their first difference,
    which must be a near tie (the two tokens' logits within ``TIE_TOL``)
    of the one-process port run along ``want``'s path; the number of
    such rows."""
    differ = [b for b in range(B) if not np.array_equal(want[b], got[b])]
    if not differ:
        return 0
    prompt = _prompt(ref, tag)
    logits, caches = make_prefill_step(cfg, max_len=S + NEW,
                                       cache_dtype=torch.float32)(
        params, prompt)
    path = [logits]
    for t in range(1, NEW):
        tok = torch.from_numpy(np.array(want[:, t - 1]))
        batch = ({"embeds": params["embed"][tok.long()][:, None]}
                 if cfg.input_mode == "embeds" else {"tokens": tok[:, None]})
        if cfg.mrope:
            batch["positions"] = torch.full((3, B, 1), S + t - 1,
                                            dtype=torch.int32)
        logits, caches = M.decode_step(cfg, params, batch, caches,
                                       S + t - 1)
        path.append(logits)
    for b in differ:
        t = int(np.flatnonzero(want[b] != got[b])[0])
        gap = float(path[t][b, int(want[b, t])] - path[t][b, int(got[b, t])])
        assert abs(gap) <= TIE_TOL, (tag, b, t, gap)
    return len(differ)


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_generate_tokens_match_reference(served, one_process, tag):
    """Equal but for counted near ties; the port's one-process tokens
    likewise."""
    ref, got = served
    _, arch, *_, B = _case(tag)
    cfg = _cfg(arch)
    want = ref[f"{tag}/tokens"]
    assert got[0][tag]["tokens"].shape == want.shape == (B, NEW)
    with torch.no_grad():
        params = _params(cfg, ref, tag)
        for tokens in (got[0][tag]["tokens"], one_process[tag]["tokens"]):
            _near_ties(cfg, params, ref, tag, B, want, tokens)


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_gathered_caches_match_reference(served, tag):
    ref, got = served
    for when in ("caches_prefill", "caches_decode"):
        keys = sorted((k for k in ref if k.startswith(f"{tag}/{when}")),
                      key=lambda k: (int(k.split("[")[1].split("]")[0]),
                                     int(k.split("[")[2].split("]")[0])))
        mine = got[0][tag][when]
        assert len(mine) == len(keys)
        for k, a in zip(keys, mine):
            assert a.shape == ref[k].shape, k
            np.testing.assert_allclose(a, ref[k], rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=k)


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_shard_caches_inverts_gather_caches(served, tag):
    _, got = served
    assert all(g[tag]["blocks_roundtrip"] for g in got)


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_ranks_bit_equal(served, tag):
    _, got = served
    for k in LOGITS + ("tokens",):
        for g in got[1:]:
            np.testing.assert_array_equal(g[tag][k], got[0][tag][k],
                                          err_msg=f"{tag} {k}")


@pytest.mark.parametrize("tag", [c[0] for c in CASES
                                 if SH.__dict__[c[3]]["kv_seq"]])
def test_kv_seq_is_split(served, tag):
    """The case tests a context-parallel cache: ``max_len`` divides the
    rule's axes, so the KV cache's (or, SSM-only, the state's) spec is
    split."""
    _, got = served
    _, arch, mesh_key, rules, *_ = _case(tag)
    cfg = _cfg(arch)
    specs = got[0][tag]["cache_specs"]
    split = [sp[0][2] for sp, ls in zip(specs, cfg.pattern)
             if ls.kind == "attn"]
    if not split:           # SSM only: the state's heads
        split = [sp[1][2] for sp in specs]
    assert all(e is not None for e in split), (tag, specs)


@pytest.mark.parametrize("tag", [c[0] for c in CASES
                                 if c[3] in NO_REGATHER and c[5] == "dense"])
def test_no_regather_tables_gather_no_parameter(served, tag):
    """The point of the B-series tables: no parameter is gathered, in
    prefill, decode or generate; a decode token moves activation rows
    only: sums over the d_model axes and over 'model' (partial products,
    the embedding), the q heads' gather and the softmax combine over the
    kv_seq axes, the vocab-parallel logits' gather (and for SSM layers
    the conv channels' gathers over 'model').  (``moe_impl='ep'`` takes
    whole d_model rows into its experts, as the reference's
    ``shard_map`` does, so it gathers their d blocks.)"""
    _, got = served
    _, arch, mesh_key, *_ = _case(tag)
    attention = any(ls.kind == "attn" for ls in _cfg(arch).pattern)
    kv = ("data", "model") if mesh_key == "2x4" else ("pod", "data",
                                                      "model")
    allowed = {("all-reduce", ("data",)), ("all-reduce", ("model",)),
               ("all-reduce", kv), ("all-gather", ("model",))}
    for g in got:
        row = g[tag]
        assert row["param_gathers"] == 0
        assert set(row["decode_msgs"]) <= allowed, (
            tag, set(row["decode_msgs"]) - allowed)
        if attention:       # the softmax combine
            assert ("all-reduce", kv) in row["decode_msgs"]


def test_serving_tables_regather_parameters(served):
    """Against the no-regather tables: the baseline ``SERVE_RULES`` does
    gather FSDP weight blocks every forward, so the counter sees them."""
    _, got = served
    assert got[0]["llama_serve"]["param_gathers"] > 0
    assert got[0]["llama_2d"]["param_gathers"] == 0


def test_check_serving_refuses_what_the_reference_refuses():
    class _Shape:
        shape = {"data": 2, "model": 4}

    cfg = get_reduced("internlm2-1.8b")
    for rules in ("SERVE_RULES", "SMALL_SERVE_RULES", "LONG_CONTEXT_RULES",
                  "DECODE_2D_RULES", "LONG_2D_RULES", "DEFAULT_RULES",
                  "TRAIN_SP_RULES"):
        for impl in SH.MOE_IMPLS:
            SH.check_ctx(cfg, SH.ShardingCtx(
                _Shape(), getattr(SH, rules), moe_impl=impl))
    with pytest.raises(ValueError, match="moe_impl"):
        SH.check_ctx(cfg, SH.ShardingCtx(_Shape(), SH.SERVE_RULES,
                                             moe_impl="ring"))
