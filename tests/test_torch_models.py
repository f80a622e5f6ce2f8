"""The port's model serving path on the CPU against the reference, module
by module and as a whole.

Weights and inputs are made with numpy from a seed (or by the reference's
own ``init_model_params``) and carried into the port with
``repro_torch.models.carry.params_from_numpy``.  On the CPU the port's
``flash_attention`` and ``ssd_chunk`` wrappers run their plain versions;
the reference runs its XLA paths (``blocked_attention``, ``ssd_chunked``).

Tolerance 1e-4 (absolute and relative) on every float comparison: both
sides compute in float32 and differ only in the order of sums (dots of at
most 256 terms here, a materialised against a blocked softmax, a sequential
against a chunked SSD scan); the observed differences are around 1e-6.
Generated tokens must be equal."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.serve import decode as RD  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.launch.serve import make_requests, serve, waves  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.carry import params_from_numpy  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# the dense token archs of the first model slice; the MoE, M-RoPE and
# embeds archs' whole-model parity is tests/test_torch_moe.py
TOKEN_ARCHS = ("internlm2-1.8b", "mamba2-2.7b", "gemma2-27b", "granite-20b")
SLICE_ARCHS = TOKEN_ARCHS + ("grok-1-314b", "moonshot-v1-16b-a3b",
                             "jamba-1.5-large-398b", "qwen2-vl-72b",
                             "musicgen-medium")


def _close(got, want):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_configs_are_the_references():
    from repro.configs import ARCH_IDS as REF_IDS, get_config as ref_config
    assert ARCH_IDS == REF_IDS
    for a in ARCH_IDS:
        for ours, theirs in ((get_config(a), ref_config(a)),
                             (get_reduced(a), ref_reduced(a))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_init_params_shapes_and_seed(arch):
    cfg = get_reduced(arch)
    ref_tree = jax.eval_shape(lambda: RM.init_model_params(
        ref_reduced(arch), jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    p = M.init_model_params(cfg, gen, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jax.tree.map(
        lambda a: a.shape, ref_tree)
    again = M.init_model_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert torch.equal(p["embed"], again["embed"])
    assert abs(float(p["embed"].std()) - 1.0) < 0.05
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == cfg.param_count()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 9, 4, 16), _rand(rng, 16, scale=0.1)
    _close(L.rmsnorm(_t(x), _t(w), 1e-6), RL.rmsnorm(x, w, 1e-6))
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(L.apply_rope(_t(x), _t(pos), theta),
               RL.apply_rope(x, pos, theta))


def _attn_setup(arch, layer, seed):
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(seed)
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, d, Hq, Dh, scale=d ** -0.5),
         "wk": _rand(rng, d, Hkv, Dh, scale=d ** -0.5),
         "wv": _rand(rng, d, Hkv, Dh, scale=d ** -0.5),
         "wo": _rand(rng, Hq, Dh, d, scale=(Hq * Dh) ** -0.5)}
    return rcfg, cfg, rcfg.pattern[layer], cfg.pattern[layer], p, rng


@pytest.mark.parametrize("arch,layer", [
    ("internlm2-1.8b", 0),      # global, GQA
    ("gemma2-27b", 0),          # local: window 16, softcap, query scale
    ("gemma2-27b", 1),          # global with softcap
    ("granite-20b", 0)])        # MQA
def test_attention_block_prefill_and_decode(arch, layer):
    rcfg, cfg, rspec, spec, p, rng = _attn_setup(arch, layer, 1)
    B, S_, max_len = 2, 37, 40
    x = _rand(rng, B, S_, cfg.d_model)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B, S_))
    kv = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
    rcache = (jnp.zeros(kv), jnp.zeros(kv))
    cache = (torch.zeros(kv), torch.zeros(kv))
    tp = {k: _t(v) for k, v in p.items()}
    block = jax.jit(RL.attention_block, static_argnums=(3, 4, 5),
                    static_argnames="mode")
    want, rcache = block(p, x, pos, rcfg, rspec, None,
                                      kv_cache=rcache, cur_len=0,
                                      mode="prefill")
    got, cache = L.attention_block(tp, _t(x), _t(pos), cfg, spec,
                                   kv_cache=cache, cur_len=0, mode="prefill")
    _close(got, want)
    for a, b in zip(cache, rcache):
        _close(a, b)
    for impl in ("reference",):
        o, _ = L.attention_block(tp, _t(x), _t(pos), cfg, spec,
                                 attn_impl=impl, mode="train")
        _close(o, want)
    for step in range(2):
        cur = S_ + step
        x1 = _rand(rng, B, 1, cfg.d_model)
        p1 = np.full((B, 1), cur, np.int32)
        want, rcache = block(p, x1, p1, rcfg, rspec, None, kv_cache=rcache,
                             cur_len=jnp.asarray(cur), mode="decode")
        got, cache = L.attention_block(tp, _t(x1), _t(p1), cfg, spec,
                                       kv_cache=cache, cur_len=cur,
                                       mode="decode")
        _close(got, want)
        for a, b in zip(cache, rcache):
            _close(a, b)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_per_row_lengths(window):
    """A (B,) tensor of valid cache lengths, as the reference allows."""
    rng = np.random.default_rng(9)
    q, k, v = _rand(rng, 3, 1, 4, 16), _rand(rng, 3, 12, 2, 16), \
        _rand(rng, 3, 12, 2, 16)
    cur = np.array([1, 7, 12], np.int32)
    got = L.decode_attention(_t(q), _t(k), _t(v), _t(cur), scale=0.25,
                             window=window, softcap=20.0)
    _close(got, RL.decode_attention(q, k, v, cur, scale=0.25, window=window,
                                    softcap=20.0))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b"])
def test_mlp_block(arch):
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    assert cfg.geglu == (arch == "gemma2-27b")
    rng = np.random.default_rng(2)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": _rand(rng, d, f, scale=d ** -0.5),
         "w3": _rand(rng, d, f, scale=d ** -0.5),
         "w2": _rand(rng, f, d, scale=f ** -0.5)}
    x = _rand(rng, 2, 5, d)
    _close(L.mlp_block({k: _t(v) for k, v in p.items()}, _t(x), cfg),
           RL.mlp_block(p, x, rcfg, None))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv(with_tail):
    rng = np.random.default_rng(3)
    seq, w, b = _rand(rng, 2, 11, 24), _rand(rng, 4, 24, scale=0.2), \
        _rand(rng, 24, scale=0.1)
    tail = _rand(rng, 2, 3, 24) if with_tail else None
    got = S._causal_conv(_t(seq), _t(w), _t(b),
                         None if tail is None else _t(tail))
    want = RS._causal_conv(seq, w, b, tail)
    for g, r in zip(got, want):
        _close(g, r)


def _ssd_inputs(seed, Bb, S_, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = _rand(rng, Bb, S_, H, P)
    dt = np.log1p(np.exp(_rand(rng, Bb, S_, H)))
    A = -np.exp(_rand(rng, H, scale=0.3))
    B_ = _rand(rng, Bb, S_, G, N, scale=0.3)
    C_ = _rand(rng, Bb, S_, G, N, scale=0.3)
    h0 = _rand(rng, Bb, H, P, N, scale=0.5)
    return x, dt, A, B_, C_, h0


@pytest.mark.parametrize("S_,chunk,G", [(75, 32, 2), (20, 32, 1)])
def test_ssd_chunked_matches_both_references(S_, chunk, G):
    """S not a multiple of Q (dt=0 padding), an initial state, grouped
    B/C: the port's chunked scan (one ssd_chunk call) against the
    reference's chunked scan and its sequential oracle."""
    x, dt, A, B_, C_, h0 = _ssd_inputs(4, 2, S_, 4, 16, G, 16)
    got = S.ssd_chunked(*map(_t, (x, dt, A, B_, C_)), chunk=chunk,
                        initial_state=_t(h0))
    chunked = jax.jit(RS.ssd_chunked, static_argnames="chunk")
    sequential = jax.jit(RS.ssd_reference)
    for want in (chunked(x, dt, A, B_, C_, chunk=chunk, initial_state=h0),
                 sequential(x, dt, A, B_, C_, initial_state=h0)):
        for g, r in zip(got, want):
            _close(g, r)
    for g, r in zip(S.ssd_reference(*map(_t, (x, dt, A, B_, C_)),
                                    initial_state=_t(h0)),
                    sequential(x, dt, A, B_, C_, initial_state=h0)):
        _close(g, r)


def test_mamba2_block_prefill_and_decode():
    rcfg, cfg = ref_reduced("mamba2-2.7b"), get_reduced("mamba2-2.7b")
    rng = np.random.default_rng(6)
    rlayer = {k: _rand(rng, *spec.shape, scale=0.2 if spec.init == "normal"
                       else 0.1)
              for k, spec in M._ssm_specs(cfg).items()}
    layer = {k: _t(v) for k, v in rlayer.items()}
    B, S_ = 2, 45
    x = _rand(rng, B, S_, cfg.d_model)
    block = jax.jit(RS.mamba2_block, static_argnums=(2, 3),
                    static_argnames="mode")
    want, rcache = block(rlayer, x, rcfg, None, mode="prefill")
    got, cache = S.mamba2_block(layer, _t(x), cfg, mode="prefill")
    _close(got, want)
    for a, b in zip(cache, rcache):
        _close(a, b)
    for _ in range(2):
        x1 = _rand(rng, B, 1, cfg.d_model)
        want, rcache = block(rlayer, x1, rcfg, None, cache=rcache,
                             mode="decode")
        got, cache = S.mamba2_block(layer, _t(x1), cfg, cache=cache,
                                    mode="decode")
        _close(got, want)
        for a, b in zip(cache, rcache):
            _close(a, b)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=TOKEN_ARCHS)
def pair(request):
    arch = request.param
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(7))
    return rcfg, cfg, ref_p, params_from_numpy(cfg, jax.device_get(ref_p),
                                               "cpu")


def test_prefill_decode_and_generate(pair):
    """Prefill logits, two decode steps' logits and caches, and greedy
    tokens, against the reference, on a prompt longer than the reduced
    window (16) and than one SSD chunk (32) and not a multiple of it."""
    rcfg, cfg, ref_p, p = pair
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32)
    max_len = 37 + 6
    want, rcaches = RD.make_prefill_step(rcfg, max_len=max_len)(
        ref_p, {"tokens": jnp.asarray(toks)})
    got, caches = D.make_prefill_step(cfg, max_len=max_len)(
        p, {"tokens": _t(toks)})
    _close(got, want)
    rstep, step = RD.make_serve_step(rcfg), D.make_serve_step(cfg)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    for cur in (37, 38):
        rtok, want, rcaches = rstep(ref_p, {"tokens": jnp.asarray(
            tok[:, None])}, rcaches, jnp.asarray(cur))
        gtok, got, caches = step(p, {"tokens": _t(tok[:, None])}, caches,
                                 cur)
        _close(got, want)
        assert np.array_equal(gtok.numpy(), np.asarray(rtok))
        tok = np.asarray(rtok)
    for ours, theirs in zip(jax.tree.leaves(caches),
                            jax.tree.leaves(rcaches)):
        assert ours.dtype == getattr(torch, str(theirs.dtype))
        _close(ours, theirs)
    want = RD.generate(rcfg, ref_p, {"tokens": jnp.asarray(toks)},
                       max_new_tokens=6)
    got = D.generate(cfg, p, {"tokens": _t(toks)}, max_new_tokens=6,
                     device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_serve_waves_match_reference_generate():
    """The port's serve loop on the reduced internlm2: each wave's tokens
    equal the reference's ``generate`` on the same left-padded wave (the
    reference server's loop; its pad mask never reaches generate)."""
    arch = "internlm2-1.8b"
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    ref_p = RM.init_model_params(rcfg, jax.random.PRNGKey(0))
    p = params_from_numpy(cfg, jax.device_get(ref_p), "cpu")
    requests = make_requests(cfg.vocab_size, 6, 40, 5, seed=0)
    rng = np.random.RandomState(0)
    assert [len(r) for r in requests] == [
        len(rng.randint(0, 256, size=rng.randint(4, 35))) for _ in range(6)]
    tokens, walls = serve(cfg, p, requests, batch=4, max_new=5, device="cpu")
    assert [t.shape for t in tokens] == [(4, 5), (2, 5)]
    for wave, got, w in zip(waves(requests, 4), tokens, walls):
        assert w["prompt_len"] == wave.shape[1]
        assert w["wall_s"] >= w["prefill_s"] + w["decode_s"] > 0
        want = RD.generate(rcfg, ref_p, {"tokens": jnp.asarray(wave)},
                           max_new_tokens=5)
        assert np.array_equal(got, np.asarray(want))
