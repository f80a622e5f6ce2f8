"""One-process training of the port (``models.model.loss_fn`` with remat,
``train.train_step``) against the reference on the CPU.

Reduced configs, parameters from the reference's own
``init_model_params`` carried across (``models.carry``), batches made
with numpy from a seed.  By default four archs run: internlm2-1.8b,
gemma2-27b (tied embeddings, softcaps, a local layer), mamba2-2.7b (SSD)
and moonshot-v1-16b-a3b (MoE); ``FUZZ_TORCH=1`` runs every arch of the
registry.  MoE routes are compared before anything else
(``test_torch_moe.reference_routes``); a near tie would stop the test.

Tolerances: loss, ``ce`` and ``aux_loss`` 1e-5 relative, ``expert_load``
equal; gradients within 1e-4 of each leaf's largest absolute value (both
sides sum in float32, in other orders; the backward of a blocked against
a materialised softmax, of a chunked scan against a loop); two train
steps' loss and grad norm 1e-5 relative and the rate 1e-6, their new
parameters and optimiser state within 1e-6 of each leaf's largest value
of the reference's optimiser on the port's gradients (int8 codes
equal).  The remat
options are the same arithmetic in another schedule, held to rtol 1e-6;
the kernels' autograd Functions against autograd of their plain versions
1e-6."""
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.carry import (  # noqa: E402
    opt_state_from_numpy, opt_state_q8_from_numpy, params_from_numpy,
    tree_to_numpy,
)
from repro_torch.train import train_step as T  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_leaves  # noqa: E402
from test_torch_moe import Routes, port_routes, reference_routes  # noqa: E402

FUZZ = os.environ.get("FUZZ_TORCH") == "1"
DEFAULT_ARCHS = ("internlm2-1.8b", "gemma2-27b", "mamba2-2.7b",
                 "moonshot-v1-16b-a3b")
ARCHS = ARCH_IDS if FUZZ else DEFAULT_ARCHS
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
B, S_, CE_CHUNK = 2, 32, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small torch ops: on one thread each, since
    under the suite's parallel workers a pool of threads per op waits on
    the other workers' (restored after the module)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def make_batch(cfg, seed, B=B, S_=S_):
    """tokens (or N(0, 1) embeddings) and targets; M-RoPE positions of
    text then an image grid."""
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab_size, (B, S_)).astype(
        np.int32)}
    if cfg.input_mode == "embeds":
        batch["embeds"] = rng.standard_normal((B, S_, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S_)).astype(
            np.int32)
    if cfg.mrope:
        batch["positions"] = chip_smoke.mrope_positions(np, B, S_)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(7))
    return rcfg, cfg, ref_p, params_from_numpy(cfg, jax.device_get(ref_p),
                                               "cpu")


def grads_close(got, want, tol=GRAD_TOL):
    flat = tree_flatten(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (k, g), (_, w) in zip(flat, wl):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=tol * max(float(np.abs(w).max()),
                                                 1e-30), err_msg=k)


def test_loss_and_grads_match_reference(pair):
    """``loss_fn`` (routes first, then loss, ``ce``, ``aux_loss`` and
    ``expert_load``) and its gradients, from the same parameters."""
    rcfg, cfg, ref_p, p = pair
    batch = make_batch(cfg, 11)
    with reference_routes() as want_log:
        (want, wm), wg = jax.jit(jax.value_and_grad(
            lambda q, b: RM.loss_fn(rcfg, q, b, None, ce_chunk=CE_CHUNK),
            has_aux=True))(ref_p, _jb(batch))
        jax.effects_barrier()
    with port_routes() as got_log:
        (got, gm), g = T.value_and_grad(
            lambda q, b: M.loss_fn(cfg, q, b, ce_chunk=CE_CHUNK), p,
            _tb(batch))
    routes = Routes(cfg, B)
    routes.check([{k: v.detach() for k, v in r.items()} for r in got_log],
                 want_log, 0)
    assert routes.near_ties == 0
    assert set(gm) == set(wm)
    for k, a, b in (("loss", got, want), ("ce", gm["ce"], wm["ce"]),
                    ("aux_loss", gm["aux_loss"], wm["aux_loss"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL,
                                   err_msg=k)
    if cfg.moe is not None:
        np.testing.assert_array_equal(gm["expert_load"].numpy(),
                                      np.asarray(wm["expert_load"]))
        assert float(gm["aux_loss"]) > 0
        assert torch.equal(got, gm["ce"] + cfg.moe.router_aux_weight
                           * gm["aux_loss"] / cfg.n_layers)
    grads_close(g, wg)
    assert all(t.dtype == torch.float32 for t in tree_leaves(g))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b"])
def test_chunked_ce_loss_with_mask_matches_reference(arch):
    """Untied and tied (softcapped) heads, with and without a loss mask,
    one chunk and several."""
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(8))
    p = params_from_numpy(cfg, jax.device_get(ref_p), "cpu")
    rng = np.random.default_rng(13)
    hidden = rng.standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    for mask in (None, (rng.random((B, S_)) < 0.6).astype(np.float32)):
        for chunk in (8, 1024):
            got = M.chunked_ce_loss(
                cfg, p, torch.from_numpy(hidden), torch.from_numpy(targets),
                chunk=chunk, mask=None if mask is None else
                torch.from_numpy(mask))
            want = RM.chunked_ce_loss(rcfg, ref_p, jnp.asarray(hidden),
                                      jnp.asarray(targets), None,
                                      chunk=chunk, mask=mask)
            np.testing.assert_allclose(float(got), float(want),
                                       rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="multiple"):
        M.chunked_ce_loss(cfg, p, torch.zeros((1, 12, cfg.d_model)),
                          torch.zeros((1, 12), dtype=torch.int32), chunk=8)


# two train steps of each optimiser and microbatch count on
# internlm2-1.8b (adamw with one microbatch, adamw8bit with two); every
# pair on every arch under FUZZ_TORCH=1
STEP_CASES = ([(a, o, n) for a in ARCHS for o in ("adamw", "adamw8bit")
               for n in (1, 2)] if FUZZ else
              [(ARCHS[0], "adamw", 1), (ARCHS[0], "adamw8bit", 2)])


def leaves_close(got, want, ctx, tol=OPT_TOL):
    """Each leaf of the port's tree within ``tol`` of the largest absolute
    value of the reference's leaf (elementwise relative where a sum
    cancels, as 0.9 m + 0.1 g, is too strict), int8 leaves equal; the
    leaves in one order under the reference's key paths."""
    flat = tree_flatten(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (k, g), (_, w) in zip(flat, wl):
        w = np.asarray(w)
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=tol * max(float(np.abs(w).max()),
                                                     1e-30),
                err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("arch,opt_impl,n_micro", STEP_CASES)
def test_train_steps_match_reference(arch, opt_impl, n_micro, monkeypatch):
    """Two steps of ``make_train_step`` on both sides, each from the same
    state: before each step the reference's parameters and optimiser
    state are carried into the port (``models.carry``), so a step's
    metrics are held to the reference's without the drift of the steps
    before (a first Adam step is about lr * sign(g): noise in a tiny
    gradient flips it).  The step's new parameters and optimiser state
    are held to the reference's optimiser (``adamw_update`` or
    ``adamw8bit_update``, at the reference's step index, rate and config)
    applied to the gradients the port's step passed to its own: within
    ``OPT_TOL`` of each leaf's largest value, int8 codes equal."""
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(9))
    kw = dict(lr=1e-3, warmup=1, total_steps=4, n_micro=n_micro, remat=None,
              ce_chunk=CE_CHUNK, opt_impl=opt_impl)
    # int8 codes are held equal without clipping: the clip's scale comes
    # from a global norm that each side sums in its own order, and one ulp
    # of it flips a code whose input lies at a rounding half
    opt_kw = {} if opt_impl == "adamw" else {"clip_norm": None}
    rhp = RT.TrainHParams(**kw, adamw=RT.AdamWConfig(**opt_kw))
    hp = T.TrainHParams(**kw, adamw=T.AdamWConfig(**opt_kw))
    if opt_impl == "adamw":
        from repro.optim.adamw import adamw_update as ref_update
        from repro.optim.adamw import init_opt_state as ref_init
        carry_opt = opt_state_from_numpy
        port_module, port_name = T, "adamw_update"
    else:
        from repro.optim.quantized import adamw8bit_update as ref_update
        from repro.optim.quantized import init_opt_state_q8 as ref_init
        from repro_torch.optim import quantized as port_module
        carry_opt = opt_state_q8_from_numpy
        port_name = "adamw8bit_update"
    seen = []
    port_update = getattr(port_module, port_name)

    def spy(params, grads, *args):
        seen.append(grads)
        return port_update(params, grads, *args)
    monkeypatch.setattr(port_module, port_name, spy)
    ropt = ref_init(ref_p)
    rstep = jax.jit(RT.make_train_step(rcfg, rhp))
    # op by op: XLA's fusion of the jitted update rounds otherwise
    rupdate = ref_update
    step = T.make_train_step(cfg, hp)
    for i in range(2):
        p = params_from_numpy(cfg, jax.device_get(ref_p), "cpu")
        opt = carry_opt(cfg, jax.device_get(ropt), "cpu")
        batch = make_batch(cfg, 20 + i)
        p0, opt0 = ref_p, ropt
        ref_p, ropt, rm = rstep(ref_p, ropt, _jb(batch),
                                jnp.asarray(i, jnp.int32))
        p, opt, m = step(p, opt, _tb(batch), i)
        wp, wopt, _ = rupdate(p0, jax.tree.map(jnp.asarray, tree_to_numpy(
            seen.pop())), opt0, jnp.asarray(i, jnp.int32), rm["lr"],
            rhp.adamw)
        leaves_close({"params": p, "opt": opt},
                     {"params": wp, "opt": wopt}, f"step {i}")
        assert set(m) == set(rm)
        for k in m:
            rtol = 1e-6 if k == "lr" else LOSS_RTOL
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       atol=1e-7 if k == "aux_loss" else 0,
                                       err_msg=f"step {i} {k}")


def test_remat_options_agree():
    """None, full, dots and dots_no_batch, and a segmented remat of 4
    super-blocks in segments of 2 (checkpoints at both levels), give one
    loss and one gradient: MoE, SSD and attention layers (a jamba-style
    stack) and a deep internlm2."""
    for arch, n_layers in (("jamba-1.5-large-398b", None),
                           ("internlm2-1.8b", 4)):
        cfg = get_reduced(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        p = M.init_model_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
        batch = _tb(make_batch(cfg, 14))
        runs = {}
        for remat, seg in ((None, 0), ("full", 0), ("dots", 0),
                           ("dots_no_batch", 0), (None, 2), ("full", 2)):
            if seg and cfg.n_superblocks % seg or (n_layers and remat
                                                    and not seg):
                continue
            runs[(remat, seg)] = T.value_and_grad(
                lambda q, b: M.loss_fn(cfg, q, b, ce_chunk=CE_CHUNK,
                                       remat=remat, remat_segment=seg),
                p, batch)
        (l0, m0), g0 = runs[(None, 0)]
        for key, ((l, m), g) in runs.items():
            np.testing.assert_allclose(float(l), float(l0), rtol=1e-6,
                                       err_msg=str(key))
            for (k, a), b in zip(tree_flatten(g), tree_leaves(g0)):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
                    b.abs().max()), msg=f"{key} {k}")
    with pytest.raises(ValueError, match="remat"):
        M.loss_fn(cfg, p, batch, remat="some")


@pytest.mark.parametrize("kw", [{}, {"causal": False},
                                {"window": 5, "softcap": 3.0},
                                {"scale": 0.2, "window": 1}])
def test_flash_attention_function_grads(kw):
    """The autograd Function on the CPU against autograd of the plain
    version (equal: one query block), and its blocked recompute (several
    blocks) within 1e-6; GQA, ragged S; in bfloat16 the float32
    gradients of the same values rounded once."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((2, 4, 37, 16), (2, 2, 37, 16), (2, 2, 37, 16)))
    out = fa.flash_attention(q, k, v, **kw)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, **kw),
                               (q, k, v), g)
    blocked = fa.flash_attention_plain_grads(q, k, v, g, rows=8, **kw)
    for a, b, c in zip(got, want, blocked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(c, b, rtol=1e-6, atol=1e-6)
    # bfloat16: the float32 gradients of the same values, rounded once
    bf = [t.detach().bfloat16().requires_grad_(True) for t in (q, k, v)]
    up = [t.detach().float().requires_grad_(True) for t in bf]
    gb = torch.autograd.grad(fa.flash_attention(*bf, **kw), bf, g.bfloat16())
    wb = torch.autograd.grad(fa.flash_attention_plain(*up, **kw), up,
                             g.bfloat16().float())
    for a, b in zip(gb, wb):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.bfloat16())


def test_ssd_chunk_function_grads():
    """The autograd Function on the CPU against autograd of the plain
    version, grouped B/C rows, gradients of all five inputs."""
    rng = np.random.default_rng(17)
    M_, Q, P, N, rep = 6, 10, 16, 32, 3

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, Bm, Cm = r(M_, Q, P), r(M_ // rep, Q, N), r(M_ // rep, Q, N)
    dt = torch.from_numpy(rng.random((M_, Q, 1)).astype(np.float32))
    cum = torch.cumsum(-dt * 0.5, dim=1)
    ins = [t.requires_grad_(True) for t in (x, dt, cum, Bm, Cm)]
    y, st = sc.ssd_chunk(*ins)
    gy, gs = r(*y.shape), r(*st.shape)
    got = torch.autograd.grad((y, st), ins, (gy, gs))
    want = torch.autograd.grad(sc.ssd_chunk_plain(*ins), ins, (gy, gs))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # only y read: the state's gradient is zero
    got = torch.autograd.grad(sc.ssd_chunk(*ins)[0], ins, gy)
    want = torch.autograd.grad(sc.ssd_chunk_plain(*ins)[0], ins, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_train_step_refusals():
    """A sharding context builds under every rules table, with
    ``gather_fsdp=False`` and ``adamw8bit`` too (ROADMAP 13g); an unknown
    optimiser raises, with a ctx or without."""
    from repro_torch.models import sharding as SH
    cfg = get_reduced("internlm2-1.8b")

    class Shape:
        shape = {"data": 2, "model": 2}
    assert callable(T.make_train_step(cfg, T.TrainHParams(),
                                      ctx=SH.ShardingCtx(Shape(),
                                                         SH.DEFAULT_RULES)))
    for ctx in (SH.ShardingCtx(Shape(), SH.LONG_2D_RULES),
                SH.ShardingCtx(Shape(), SH.SMALL_SERVE_RULES),
                SH.ShardingCtx(Shape(), SH.DEFAULT_RULES,
                               gather_fsdp=False)):
        assert callable(T.make_train_step(cfg, T.TrainHParams(), ctx=ctx))
    assert callable(T.make_train_step(
        cfg, T.TrainHParams(opt_impl="adamw8bit"),
        ctx=SH.ShardingCtx(Shape(), SH.DEFAULT_RULES)))
    with pytest.raises(ValueError, match="opt_impl"):
        T.make_train_step(cfg, T.TrainHParams(opt_impl="sgd"))
    with pytest.raises(ValueError, match="opt_impl"):
        T.make_train_step(cfg, T.TrainHParams(opt_impl="sgd"),
                          ctx=SH.ShardingCtx(Shape(), SH.DEFAULT_RULES))
