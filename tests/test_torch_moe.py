"""The model substrate that serving needs beyond the dense path, on the CPU
against the reference: M-RoPE, the token-choice MoE block, ``embeds``
inputs, and the five architectures that use them (grok-1-314b,
moonshot-v1-16b-a3b and jamba-1.5-large-398b with MoE layers,
qwen2-vl-72b with M-RoPE and embeddings, musicgen-medium with
embeddings), reduced.

Weights and inputs are made with numpy from a seed (or by the reference's
own ``init_model_params``) and carried into the port with
``repro_torch.models.carry.params_from_numpy``.  Tolerance 1e-4
(absolute and relative) on every float comparison, as in
``tests/test_torch_models.py``: both sides compute in float32 and differ
only in the order of sums.  ``expert_load`` (choices kept per expert, a
count) must be equal, and generated tokens equal.

Routing is compared before any output (``chip_smoke.compare_routes``).
The reference runs with its ``moe_block`` wrapped to log each call's own
router probabilities, top-k experts and kept choices (an ordered debug
callback); the port logs the same in ``models.layers.ROUTES``.  A token
may route differently only at a near tie: its K-th and (K+1)-th router
probabilities within ``MARGIN`` = 1e-4 of each other.  The two sides'
probabilities differ by up to about 2e-6 here (float32 sums in another
order, grown through up to eight layers); each test checks that this
error stays under a tenth of the margin, so a difference wider than the
margin is a fault and one inside it is a tie that either order may
break.  Outputs are compared
only where no route differed upstream; every near tie is counted.  At
these sizes none is expected, and the tests use the seeds they were
written with.  ``test_moe_block_corpus`` runs 4 of its 40 seeded shapes
by default, all under ``FUZZ_TORCH=1``."""
import contextlib
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.serve import make_requests, serve, waves  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.carry import params_from_numpy  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
FUZZ = os.environ.get("FUZZ_TORCH") == "1"
# moe_block corpus: 4 of its 40 seeds by default, all under FUZZ_TORCH=1
MOE_SEEDS = range(40) if FUZZ else (0, 1, 2, 3)
MOE_ARCHS = ("grok-1-314b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b")
NEW_ARCHS = MOE_ARCHS + ("qwen2-vl-72b", "musicgen-medium")


def _close(got, want):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# routing on both sides
# ---------------------------------------------------------------------------


class _Spy:
    """A stand-in for a module that passes every attribute through and
    keeps, for each hooked function, ``pick(args, result)`` of its first
    call."""

    def __init__(self, mod, **hooks):
        self._mod, self._hooks, self.seen = mod, hooks, {}

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if name not in self._hooks:
            return fn

        def spy(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.seen.setdefault(name, self._hooks[name](args, out))
            return out
        return spy


@contextlib.contextmanager
def reference_routes():
    """Run the reference with ``moe_block`` wrapped to log each call's
    routing, in ``models.layers.ROUTES``'s format, through an ordered
    debug callback (the calls come in program order under ``lax.scan``
    and ``jit``).  The logged values are the reference's own: while its
    ``moe_block`` traces, its ``lax`` and ``jnp`` are spies that keep
    ``lax.top_k``'s input and experts (the router probabilities and
    ``top_e``), ``jnp.argsort``'s order of the flat choices and the
    condition of its first ``jnp.where``, ``keep`` in that order."""
    log, orig, real_lax, real_jnp = [], RL.moe_block, RL.lax, RL.jnp

    def record(probs, top_e, perm, keep):
        kept = np.empty(keep.shape, bool)
        kept[np.asarray(perm)] = np.asarray(keep)
        log.append({"probs": _t(probs), "top_e": _t(top_e),
                    "keep": _t(kept.reshape(np.shape(top_e)))})

    def logged(params, x, cfg, ctx):
        RL.lax = lax = _Spy(real_lax, top_k=lambda a, out: (a[0], out[1]))
        RL.jnp = jnp_ = _Spy(real_jnp, argsort=lambda a, out: out,
                             where=lambda a, out: a[0])
        try:
            out = orig(params, x, cfg, ctx)
        finally:
            RL.lax, RL.jnp = real_lax, real_jnp
        (probs, top_e), perm = lax.seen["top_k"], jnp_.seen["argsort"]
        keep = jnp_.seen["where"]
        assert keep.dtype == real_jnp.bool_ and keep.shape == perm.shape
        jax.debug.callback(record, probs[0], top_e[0], perm[0], keep[0],
                           ordered=True)
        return out

    RL.moe_block = logged
    try:
        yield log
    finally:
        RL.moe_block = orig
        jax.effects_barrier()


@contextlib.contextmanager
def port_routes():
    L.ROUTES = []
    try:
        yield L.ROUTES
    finally:
        L.ROUTES = None


class Routes:
    """Route comparisons across the passes of one run (a prefill, then
    decode steps): each row's first position whose outputs may differ,
    and the counts of ``chip_smoke.compare_routes``."""

    def __init__(self, cfg, B):
        self.n_moe = cfg.n_superblocks * sum(s.mlp == "moe"
                                             for s in cfg.pattern)
        self.first = [1 << 30] * B
        self.near_ties = 0

    def check(self, got, want, p0):
        assert len(got) == len(want) == self.n_moe
        if not self.n_moe:
            return
        c = chip_smoke.compare_routes(torch, got, want, self.first, p0,
                                      MARGIN)
        assert c["max_prob_err"] <= MARGIN / 10, c
        self.near_ties += c["near_ties"]

    def check_passes(self, got, want, p0s):
        n = self.n_moe
        for i, p0 in enumerate(p0s):
            self.check(got[i * n:(i + 1) * n], want[i * n:(i + 1) * n], p0)

    def clean(self, row, pos):
        return pos < self.first[row]


def _route(probs, K, keep=None):
    probs = torch.tensor(probs, dtype=torch.float32)
    top_e = probs.topk(K, dim=-1).indices
    return {"probs": probs, "top_e": top_e,
            "keep": torch.ones_like(top_e, dtype=torch.bool)
            if keep is None else torch.tensor(keep)}


def test_compare_routes_counts_near_ties_and_refuses_others():
    """Two rows of three tokens, top-1 of 3 experts.  A route difference
    at a near tie is counted and taints its row from its position on; the
    same difference past the margin, or a kept choice that differs with no
    route difference, is a fault."""
    want = [_route([[.5, .3, .2], [.4, .35, .25], [.2, .3, .5],
                    [.6, .3, .1], [.3, .35 + 2e-5, .35 - 2e-5],
                    [.1, .8, .1]], 1)]
    # token 4 (row 1, position 11) picks expert 2 against 1: a near tie
    got = [_route([[.5, .3, .2], [.4, .35, .25], [.2, .3, .5],
                   [.6, .3, .1], [.3, .35 - 2e-5, .35 + 2e-5],
                   [.1, .8, .1]], 1)]
    first = [1 << 30] * 2
    c = chip_smoke.compare_routes(torch, got, want, first, 10, 1e-4)
    assert first == [1 << 30, 11]
    assert c["near_ties"] == 1 and c["downstream"] == 0
    assert 0 < c["max_tie_gap"] <= 1e-4
    # the tainted position differs again in a later layer: downstream
    c = chip_smoke.compare_routes(torch, got, want, first, 10, 1e-4)
    assert c["near_ties"] == 0 and c["downstream"] == 1
    with pytest.raises(AssertionError, match="gap"):
        chip_smoke.compare_routes(torch, got, want, [1 << 30] * 2, 10, 1e-5)
    keep = [[True]] * 6
    lost = _route(want[0]["probs"].tolist(), 1, keep[:2] + [[False]]
                  + keep[3:])
    with pytest.raises(AssertionError, match="kept other choices"):
        chip_smoke.compare_routes(torch, [lost], [_route(
            want[0]["probs"].tolist(), 1)], [1 << 30] * 2, 0, 1e-4)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def test_mrope_sections():
    assert L.mrope_sections(128) == (16, 24, 24)
    assert L.mrope_sections(16) == (2, 3, 3)
    for d in (16, 32, 64, 80, 128, 256):
        assert L.mrope_sections(d) == RL.mrope_sections(d)
        assert sum(L.mrope_sections(d)) == d // 2


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_mrope(theta):
    """Distinct temporal, height and width positions, so each section of
    the frequencies turns by its own axis."""
    rng = np.random.default_rng(10)
    x = _rand(rng, 2, 9, 4, 16)
    pos = rng.integers(0, 4000, (3, 2, 9)).astype(np.int32)
    _close(L.apply_mrope(_t(x), _t(pos), theta),
           RL.apply_mrope(x, pos, theta))


def test_attention_block_mrope_prefill_and_decode():
    arch = "qwen2-vl-72b"
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(11)
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, d, Hq, Dh, scale=d ** -0.5),
         "wk": _rand(rng, d, Hkv, Dh, scale=d ** -0.5),
         "wv": _rand(rng, d, Hkv, Dh, scale=d ** -0.5),
         "wo": _rand(rng, Hq, Dh, d, scale=(Hq * Dh) ** -0.5)}
    tp = {k: _t(v) for k, v in p.items()}
    B, S_, max_len = 2, 21, 24
    x = _rand(rng, B, S_, d)
    # a (t, h, w) grid of patches after two text tokens
    t_ = np.r_[0, 1, np.full(S_ - 2, 2)]
    h_ = np.r_[0, 1, 2 + np.arange(S_ - 2) // 5]
    w_ = np.r_[0, 1, 2 + np.arange(S_ - 2) % 5]
    pos = np.broadcast_to(np.stack([t_, h_, w_])[:, None], (3, B, S_)
                          ).astype(np.int32)
    kv = (B, max_len, Hkv, Dh)
    rcache, cache = (jnp.zeros(kv), jnp.zeros(kv)), (torch.zeros(kv),
                                                    torch.zeros(kv))
    spec, rspec = cfg.pattern[0], rcfg.pattern[0]
    block = jax.jit(RL.attention_block, static_argnums=(3, 4, 5),
                    static_argnames="mode")
    want, rcache = block(p, x, pos, rcfg, rspec, None, kv_cache=rcache,
                         cur_len=0, mode="prefill")
    got, cache = L.attention_block(tp, _t(x), _t(pos), cfg, spec,
                                   kv_cache=cache, cur_len=0, mode="prefill")
    _close(got, want)
    for step in range(2):
        cur = S_ + step
        x1 = _rand(rng, B, 1, d)
        p1 = np.full((3, B, 1), int(h_.max()) + 1 + step, np.int32)
        want, rcache = block(p, x1, p1, rcfg, rspec, None, kv_cache=rcache,
                             cur_len=jnp.asarray(cur), mode="decode")
        got, cache = L.attention_block(tp, _t(x1), _t(p1), cfg, spec,
                                       kv_cache=cache, cur_len=cur,
                                       mode="decode")
        _close(got, want)
        for a, b in zip(cache, rcache):
            _close(a, b)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


def _moe_params(cfg, rng):
    return {k: _rand(rng, *spec.shape, scale=spec.scale)
            for k, spec in M._moe_specs(cfg).items()}


@pytest.mark.parametrize("arch,B,S_,n_shared", [
    ("moonshot-v1-16b-a3b", 2, 37, 0),      # prefill: C = 23 of 74 choices
    ("moonshot-v1-16b-a3b", 3, 1, 0),       # decode: C = 1, 6 choices, 4 slots
    ("moonshot-v1-16b-a3b", 2, 1, 0),       # decode: C = 1
    ("grok-1-314b", 2, 37, 0),
    ("grok-1-314b", 3, 1, 0),
    ("jamba-1.5-large-398b", 4, 9, 0),
    ("moonshot-v1-16b-a3b", 2, 37, 2),      # shared experts
    ("moonshot-v1-16b-a3b", 3, 1, 1),
    ("grok-geglu", 2, 11, 1),               # GeGLU experts
])
def test_moe_block(arch, B, S_, n_shared):
    if arch == "grok-geglu":
        rcfg = dataclasses.replace(ref_reduced("grok-1-314b"), geglu=True)
        cfg = dataclasses.replace(get_reduced("grok-1-314b"), geglu=True)
    else:
        rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    if n_shared:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, n_shared=n_shared))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared=n_shared))
    m = cfg.moe
    rng = np.random.default_rng(B * 100 + S_ + n_shared)
    p = _moe_params(cfg, rng)
    assert ("shared_w1" in p) == bool(n_shared)
    x = _rand(rng, B, S_, cfg.d_model)
    with reference_routes() as want_log:
        want, wstats = jax.jit(RL.moe_block, static_argnums=(2, 3))(
            p, x, rcfg, None)
    with port_routes() as got_log:
        got, stats = L.moe_block({k: _t(v) for k, v in p.items()}, _t(x),
                                 cfg)
    routes = Routes(cfg, B)
    routes.n_moe = 1
    routes.check(got_log, want_log, 0)
    assert routes.near_ties == 0
    C = max(1, int(B * S_ * m.top_k * m.capacity_factor) // m.n_experts)
    kept = int(got_log[0]["keep"].sum())
    assert kept == float(wstats["expert_load"].sum()) <= m.n_experts * C
    if S_ == 1:
        assert C == 1 and kept < B * m.top_k      # decode drops choices
    _close(got, want)
    _close(stats["aux_loss"], wstats["aux_loss"])
    assert stats["expert_load"].dtype == torch.float32
    assert np.array_equal(stats["expert_load"].numpy(),
                          np.asarray(wstats["expert_load"]))


def moe_case(seed):
    """A seeded MoE shape: experts, top-k, capacity factor, shared
    experts, activation, rows and tokens a row (decode S = 1 in a
    quarter of the seeds)."""
    rng = np.random.default_rng(1000 + seed)
    E = int(rng.choice([2, 4, 8, 16, 64]))
    K = int(rng.integers(1, min(E, 6) + 1))
    moe = dataclasses.replace(
        get_reduced("moonshot-v1-16b-a3b").moe, n_experts=E, top_k=K,
        capacity_factor=float(rng.choice([0.5, 1.0, 1.25, 2.0])),
        n_shared=int(rng.integers(0, 3)),
        d_ff_expert=int(rng.choice([16, 64])))
    geglu = bool(rng.integers(0, 2))
    B = int(rng.integers(1, 5))
    S_ = 1 if seed % 4 == 3 else int(rng.integers(2, 40))
    return moe, geglu, B, S_, rng


@pytest.mark.parametrize("seed", MOE_SEEDS)
def test_moe_block_corpus(seed):
    """moe_block on seeded shapes (dropping capacities from C = 1 up,
    shared experts, GeGLU) against the reference: routes, kept choices,
    out, ``aux_loss`` and exact ``expert_load``."""
    moe, geglu, B, S_, rng = moe_case(seed)
    rcfg = dataclasses.replace(ref_reduced("moonshot-v1-16b-a3b"),
                               geglu=geglu, moe=moe)
    cfg = dataclasses.replace(get_reduced("moonshot-v1-16b-a3b"),
                              geglu=geglu, moe=moe)
    p = _moe_params(cfg, rng)
    x = _rand(rng, B, S_, cfg.d_model)
    with reference_routes() as want_log:
        want, wstats = jax.jit(RL.moe_block, static_argnums=(2, 3))(
            p, x, rcfg, None)
    with port_routes() as got_log:
        got, stats = L.moe_block({k: _t(v) for k, v in p.items()}, _t(x),
                                 cfg)
    routes = Routes(cfg, B)
    routes.n_moe = 1
    routes.check(got_log, want_log, 0)
    assert routes.near_ties == 0
    _close(got, want)
    _close(stats["aux_loss"], wstats["aux_loss"])
    assert np.array_equal(stats["expert_load"].numpy(),
                          np.asarray(wstats["expert_load"]))


def test_moe_block_keeps_the_stable_order():
    """All tokens choose the same two experts at decode (C = 1): the
    first token keeps both slots and the others are dropped, as the
    reference's stable sort orders them."""
    cfg, rcfg = get_reduced("grok-1-314b"), ref_reduced("grok-1-314b")
    rng = np.random.default_rng(12)
    p = _moe_params(cfg, rng)
    p["router"][:] = 0.0
    p["router"][:, 2] = 1.0
    p["router"][:, 0] = 0.5
    x = np.abs(_rand(rng, 3, 1, cfg.d_model)) + 0.1
    with port_routes() as got_log:
        got, stats = L.moe_block({k: _t(v) for k, v in p.items()}, _t(x),
                                 cfg)
    want, wstats = jax.jit(RL.moe_block, static_argnums=(2, 3))(
        p, x, rcfg, None)
    assert got_log[0]["keep"].tolist() == [[True, True], [False, False],
                                           [False, False]]
    assert stats["expert_load"].tolist() == [1.0, 0.0, 1.0, 0.0]
    assert np.array_equal(np.asarray(wstats["expert_load"]),
                          stats["expert_load"].numpy())
    _close(got, want)
    assert float(got[1:].abs().max()) == 0.0


@pytest.mark.parametrize("n_shared", [0, 2])
def test_params_carry_moe_tree(n_shared):
    """The reference's MoE parameter tree carries into the port name for
    name and shape for shape, shared experts included."""
    rcfg, cfg = ref_reduced("moonshot-v1-16b-a3b"), get_reduced(
        "moonshot-v1-16b-a3b")
    if n_shared:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, n_shared=n_shared))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared=n_shared))
    ref_p = jax.device_get(RM.init_model_params(rcfg,
                                                jax.random.PRNGKey(3)))
    p = params_from_numpy(cfg, ref_p, "cpu")
    blk = p["blocks"][0]
    E, d, f, n = (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert,
                  cfg.n_superblocks)
    assert blk["mlp_router"].shape == (n, d, E)
    assert blk["mlp_w1"].shape == blk["mlp_w3"].shape == (n, E, d, f)
    assert blk["mlp_w2"].shape == (n, E, f, d)
    assert ("mlp_shared_w1" in blk) == bool(n_shared)
    for k, v in blk.items():
        assert np.array_equal(v.numpy(), ref_p["blocks"][0][k])
    assert sum(t.numel() for t in jax.tree.leaves(p)) == cfg.param_count()


# ---------------------------------------------------------------------------
# the five architectures, reduced
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    arch = request.param
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(7))
    return rcfg, cfg, ref_p, params_from_numpy(cfg, jax.device_get(ref_p),
                                               "cpu")


def prompt_batch(cfg, B, S_, seed):
    """A prompt as tests/test_system.py makes one, with numpy: tokens, or
    embeddings N(0, 1) in an ``embeds`` config; under M-RoPE (3, B, S)
    positions with distinct axes (``chip_smoke.mrope_positions``: text,
    then an image grid)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        batch = {"embeds": _rand(rng, B, S_, cfg.d_model)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (B, S_)).astype(np.int32)}
    if cfg.mrope:
        batch["positions"] = chip_smoke.mrope_positions(np, B, S_)
    return batch


def _ref_step_batch(cfg, ref_p, tok, cur):
    """The reference generate's decode batch."""
    if cfg.input_mode == "embeds":
        batch = {"embeds": ref_p["embed"][tok][:, None]}
    else:
        batch = {"tokens": jnp.asarray(tok)[:, None]}
    if cfg.mrope:
        batch["positions"] = jnp.full((3, len(tok), 1), cur, jnp.int32)
    return batch


def test_run_stack_stats(pair):
    """The whole stack in train mode: hidden states and the summed stats
    (``aux_loss``, and ``expert_load`` for an MoE config).  In prefill
    mode the same hidden states and zero stats (serving reads none)."""
    rcfg, cfg, ref_p, p = pair
    B, S_ = 2, 37
    batch = prompt_batch(cfg, B, S_, 13)
    tb = {k: _t(v) for k, v in batch.items()}
    x = M.embed_inputs(cfg, p, tb)
    default = M.make_positions(cfg, B, S_)
    assert tuple(default.shape) == ((3, B, S_) if cfg.mrope else (B, S_))
    assert np.array_equal(default.numpy(), np.asarray(
        RM.make_positions(rcfg, B, S_)))
    pos = tb.get("positions", default)
    with reference_routes() as want_log:
        rx = RM.embed_inputs(rcfg, ref_p, {k: jnp.asarray(v)
                                           for k, v in batch.items()}, None)
        want, _, wstats = RM.run_stack(rcfg, ref_p, rx, jnp.asarray(
            pos.numpy()), None, mode="train")
    with port_routes() as got_log:
        got, caches, stats = M.run_stack(cfg, p, x, pos, mode="train")
    assert caches is None
    routes = Routes(cfg, B)
    routes.check(got_log, want_log, 0)
    assert routes.near_ties == 0
    _close(got, want)
    assert set(stats) == set(wstats) == (
        {"aux_loss", "expert_load"} if cfg.moe else {"aux_loss"})
    _close(stats["aux_loss"], wstats["aux_loss"])
    if cfg.moe:
        load = stats["expert_load"]
        assert np.array_equal(load.numpy(), np.asarray(wstats["expert_load"]))
        assert float(load.sum()) > 0
    else:
        assert float(stats["aux_loss"]) == 0.0
    caches = M.init_caches(cfg, B, S_, torch.float32, device="cpu")
    hidden, _, zeros = M.run_stack(cfg, p, x, pos, mode="prefill",
                                   caches=caches, cur_len=0)
    _close(hidden, want)
    assert set(zeros) == set(stats)
    assert all(not v.any() and v.shape == stats[k].shape
               for k, v in zeros.items())


def test_prefill_decode_and_generate(pair):
    """Prefill hidden states, caches (float32, as ``generate`` keeps
    them) and first logits, two decode steps' logits (the reference
    generate's decode batches: embeddings from the token table, M-RoPE
    positions filled with the step's position), and greedy tokens of
    ``generate``, against the reference, routing first;
    a prompt longer than one SSD chunk (32) and not a multiple of it."""
    rcfg, cfg, ref_p, p = pair
    B, S_, new = 2, 37, 6
    batch = prompt_batch(cfg, B, S_, 8)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    max_len = S_ + new
    routes = Routes(cfg, B)
    with reference_routes() as want_log:
        rhidden, _, rlen = RM.prefill(rcfg, ref_p, rbatch, max_len=max_len)
        want, rcaches = RD.make_prefill_step(
            rcfg, max_len=max_len, cache_dtype=jnp.float32)(ref_p, rbatch)
    with port_routes() as got_log:
        hidden, _, plen = M.prefill(cfg, p, tb, max_len=max_len)
        got, caches = D.make_prefill_step(
            cfg, max_len=max_len, cache_dtype=torch.float32)(p, tb)
    assert plen == rlen == S_
    routes.check_passes(got_log, want_log, (0, 0))
    for b in range(B):
        n = min(S_, routes.first[b])
        _close(hidden[b, :n], rhidden[b, :n])
        if routes.clean(b, S_ - 1):
            _close(got[b], want[b])
    rstep, step = RD.make_serve_step(rcfg), D.make_serve_step(cfg)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    for cur in (S_, S_ + 1):
        sb = D.step_batch(cfg, p, _t(tok), cur)
        rsb = _ref_step_batch(rcfg, ref_p, tok, cur)
        assert sorted(sb) == sorted(rsb)
        for k in sb:
            _close(sb[k], rsb[k])
        with reference_routes() as want_log:
            rtok, want, rcaches = rstep(ref_p, rsb, rcaches,
                                        jnp.asarray(cur))
        with port_routes() as got_log:
            gtok, got, caches = step(p, sb, caches, cur)
        routes.check(got_log, want_log, cur)
        for b in range(B):
            if routes.clean(b, cur):
                _close(got[b], want[b])
                assert int(gtok[b]) == int(rtok[b])
        tok = np.asarray(rtok)
    if not routes.near_ties:
        for ours, theirs in zip(jax.tree.leaves(caches),
                                jax.tree.leaves(rcaches)):
            assert ours.dtype == getattr(torch, str(theirs.dtype))
            _close(ours, theirs)
    routes = Routes(cfg, B)
    with reference_routes() as want_log:
        want = np.asarray(RD.generate(rcfg, ref_p, rbatch,
                                      max_new_tokens=new))
    with port_routes() as got_log:
        got = D.generate(cfg, p, tb, max_new_tokens=new, device="cpu")
    routes.check_passes(got_log, want_log,
                        [0] + [S_ + i for i in range(new - 1)])
    assert got.dtype == torch.int32 and got.shape == (B, new)
    for b in range(B):
        n = sum(routes.clean(b, S_ - 1 + i) for i in range(new))
        assert n == new or routes.near_ties
        assert np.array_equal(got[b, :n].numpy(), want[b, :n])
    assert routes.near_ties == 0


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-72b"])
def test_serve_refuses_embeds_configs(arch):
    """``serve`` answers token prompts, as the reference's server: an
    ``embeds`` config raises (the reference fails there with a
    ``KeyError``); ``generate`` serves it."""
    cfg = get_reduced(arch)
    params = M.init_model_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="embeds"):
        serve(cfg, params, [np.zeros(4, np.int32)], batch=1, max_new=2,
              device="cpu")
    out = D.generate(cfg, params, prompt_batch(cfg, 1, 5, 0),
                     max_new_tokens=3, device="cpu")
    assert out.shape == (1, 3)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size


def test_serve_moe_waves_match_reference_generate():
    """The port's serve loop on the reduced moonshot (MoE, 4 experts,
    top-2): each wave's tokens equal the reference's ``generate`` on the
    same left-padded wave."""
    arch = "moonshot-v1-16b-a3b"
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(1))
    p = params_from_numpy(cfg, jax.device_get(ref_p), "cpu")
    requests = make_requests(cfg.vocab_size, 6, 40, 5, seed=1)
    with port_routes() as got_log:
        tokens, _ = serve(cfg, p, requests, batch=4, max_new=5,
                          device="cpu")
    assert [t.shape for t in tokens] == [(4, 5), (2, 5)]
    with reference_routes() as want_log:
        want = [np.asarray(RD.generate(rcfg, ref_p, {"tokens": jnp.asarray(
            wave)}, max_new_tokens=5)) for wave in waves(requests, 4)]
    n = len(got_log) // 2
    for i, (wave, got) in enumerate(zip(waves(requests, 4), tokens)):
        routes = Routes(cfg, wave.shape[0])
        S_ = wave.shape[1]
        routes.check_passes(got_log[i * n:(i + 1) * n],
                            want_log[i * n:(i + 1) * n],
                            [0] + [S_ + j for j in range(4)])
        assert routes.near_ties == 0
        assert np.array_equal(got, want[i])
