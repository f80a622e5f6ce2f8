"""The port's tree utilities and optimisers (``repro_torch.utils.tree``,
``repro_torch.optim``) against the reference on the same arrays.

Inputs are made with numpy from a seed.  Tolerances: the tree utilities'
structure and leaf order exactly; AdamW, its int8 variant and the
warmup-cosine schedule rtol 1e-6 (both sides compute in float32; sums of
squares over a leaf may add in another order); ``quantize_blockwise``
codes and scales bit for bit (one division, one round half to even, one
clip on the same float32 values), and the int8 update's codes equal."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import quantized as RQ  # noqa: E402
from repro.utils import tree as RT  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.carry import (  # noqa: E402
    opt_state_from_numpy, opt_state_q8_from_numpy, params_from_numpy,
    tree_to_numpy,
)
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.optim import quantized as Q  # noqa: E402
from repro_torch.utils import tree as T  # noqa: E402

RTOL = 1e-6
# tests/test_quantized_opt.py's shapes, then ragged lengths of one axis
Q_SHAPES = [(7,), (3, 5), (2, 3, 130), (4, 256), (1, 1, 1),
            (1,), (127,), (128,), (129,), (1000,)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small torch ops: on one thread each, since
    under the suite's parallel workers a pool of threads per op waits on
    the other workers' (restored after the module)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tree(rng, scale=1.0):
    """A nested tree as the models' parameters nest: dicts, a list of
    dicts, 1-D and 2-D leaves (weight decay only on the 2-D ones)."""
    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": r(11, 6), "final_ln": r(6),
            "blocks": [{"wq": r(2, 6, 4), "ln": r(2, 6)},
                       {"w1": r(2, 6, 9), "b": r(3)}],
            "lm_head": r(6, 11)}


def _t(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_close(got, want, rtol=RTOL):
    """Each leaf within ``rtol``, relative to the element or to the leaf's
    largest value (where a sum of two terms cancels, as 0.9 m + 0.1 g)."""
    g, w = T.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()))


def test_tree_utils_match_reference():
    rng = np.random.default_rng(0)
    tree, other = _tree(rng), _tree(rng)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [k for k, _ in T.tree_flatten(_t(tree))] == paths
    assert paths[0] == "['blocks'][0]['ln']"
    _leaves_close(T.tree_add(_t(tree), _t(other)),
                  RT.tree_add(_j(tree), _j(other)), rtol=0)
    _leaves_close(T.tree_scale(_t(tree), 0.3),
                  RT.tree_scale(_j(tree), 0.3), rtol=0)
    np.testing.assert_allclose(float(T.global_sq_norm(_t(tree))),
                               float(RT.global_sq_norm(_j(tree))), rtol=RTOL)
    assert T.tree_size(_t(tree)) == RT.tree_size(_j(tree))
    assert T.tree_bytes(_t(tree)) == RT.tree_bytes(_j(tree))
    half = T.tree_cast(_t(tree), torch.bfloat16)
    assert T.tree_bytes(half) == RT.tree_bytes(RT.tree_cast(_j(tree),
                                                            jnp.bfloat16))
    zeros = T.tree_zeros_like(_t(tree), torch.float32)
    assert all(not z.any() for z in T.tree_leaves(zeros))
    assert jax.tree.map(lambda t: tuple(t.shape), zeros) == jax.tree.map(
        lambda a: a.shape, tree)
    back = T.tree_unflatten(tree, T.tree_leaves(_t(tree)))
    _leaves_close(back, tree, rtol=0)


@pytest.mark.parametrize("clip", [1.0, None, 1e3])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng, 0.5)
    m, v = _tree(rng, 0.01), T.tree_map(np.abs, _tree(rng, 1e-4))
    cfg = A.AdamWConfig(clip_norm=clip)
    rcfg = RA.AdamWConfig(clip_norm=clip)
    for step in (0, 3, 11):
        got = A.adamw_update(_t(params), _t(grads), {"m": _t(m), "v": _t(v)},
                             torch.tensor(step, dtype=torch.int32),
                             torch.tensor(2e-3), cfg)
        want = jax.jit(RA.adamw_update, static_argnums=5)(
            _j(params), _j(grads),
                               {"m": _j(m), "v": _j(v)},
                               jnp.asarray(step, jnp.int32),
                               jnp.asarray(2e-3, jnp.float32), rcfg)
        _leaves_close(got[0], want[0])
        _leaves_close(got[1], want[1])
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=RTOL)
    t = A.bias_corrections(torch.tensor(7), cfg, torch.device("cpu"))
    assert all(c.dtype == torch.float32 for c in t)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    grads = _tree(rng, 3.0)
    for max_norm in (0.5, 1e6):
        got, gn = A.clip_by_global_norm(_t(grads), max_norm)
        want, wn = RA.clip_by_global_norm(_j(grads), max_norm)
        _leaves_close(got, want)
        np.testing.assert_allclose(float(gn), float(wn), rtol=RTOL)
    sq = T.global_sq_norm(_t(grads))
    got, _ = A.clip_by_global_norm(_t(grads), 0.5, sq_norm=sq * 4)
    want, _ = RA.clip_by_global_norm(_j(grads), 0.5,
                                     sq_norm=RT.global_sq_norm(_j(grads)) * 4)
    _leaves_close(got, want)


def test_warmup_cosine_matches_reference():
    got_s = A.warmup_cosine(3e-4, 2, 10)
    want_s = RA.warmup_cosine(3e-4, 2, 10)
    for step in range(13):
        got = got_s(torch.tensor(step, dtype=torch.int32))
        want = want_s(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        assert float(got_s(step)) == float(got)
    for warmup, total in ((0, 5), (4, 4)):
        for step in range(7):
            np.testing.assert_allclose(
                float(A.warmup_cosine(1e-3, warmup, total)(step)),
                float(RA.warmup_cosine(1e-3, warmup, total)(
                    jnp.asarray(step, jnp.int32))), rtol=RTOL)


@pytest.mark.parametrize("shape", Q_SHAPES, ids=str)
def test_quantize_blockwise_bit_equal(shape):
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 4, shape)
         ).astype(np.float32)
    x.reshape(-1)[::5] = 0.0                     # zeros and exact ties
    x.reshape(-1)[1::7] = 0.5
    q, s = Q.quantize_blockwise(torch.from_numpy(x))
    rq, rs = RQ.quantize_blockwise(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == Q.scale_shape(shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    back = Q.dequantize_blockwise(q, s)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        RQ.dequantize_blockwise(rq, rs)))
    assert Q.scale_shape(shape) == RQ.scale_shape(shape)


def test_quantize_blockwise_scalar():
    x = np.float32(-3.25)
    q, s = Q.quantize_blockwise(torch.tensor(x))
    rq, rs = RQ.quantize_blockwise(jnp.asarray(x))
    assert q.shape == () and int(q) == int(rq)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert float(Q.dequantize_blockwise(q, s)) == float(
        RQ.dequantize_blockwise(rq, rs))
    assert Q.scale_shape(()) == RQ.scale_shape(()) == (1,)


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw8bit_update_matches_reference(clip):
    rng = np.random.default_rng(3)
    params, grads = _tree(rng), _tree(rng, 0.5)
    cfg, rcfg = A.AdamWConfig(clip_norm=clip), RA.AdamWConfig(clip_norm=clip)
    st, rst = Q.init_opt_state_q8(_t(params)), RQ.init_opt_state_q8(
        _j(params))
    p, rp = _t(params), _j(params)
    for step in range(3):
        p, st, gn = Q.adamw8bit_update(p, _t(grads), st,
                                       torch.tensor(step), 1e-3, cfg)
        rp, rst, rgn = jax.jit(RQ.adamw8bit_update, static_argnums=5)(
            rp, _j(grads), rst,
                                           jnp.asarray(step, jnp.int32),
                                           jnp.asarray(1e-3, jnp.float32),
                                           rcfg)
        _leaves_close(p, rp)
        np.testing.assert_allclose(float(gn), float(rgn), rtol=RTOL)
        for (k, a), b in zip(T.tree_flatten(st), jax.tree.leaves(rst)):
            if k.endswith("_q']"):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _leaves_close([a], [b])
        # the next step from the same state on both sides
        st = opt_state_q8_like(st, rst)


def opt_state_q8_like(st, rst):
    """The reference's state carried into the port's tree."""
    return T.tree_unflatten(st, [torch.from_numpy(np.array(a))
                                 for a in jax.tree.leaves(rst)])


def test_q8_state_is_4x_smaller():
    params = {"w": torch.zeros((1024, 1024))}
    f32 = T.tree_bytes(A.init_opt_state(params))
    q8 = T.tree_bytes(Q.init_opt_state_q8(params))
    assert q8 < f32 / 3.5
    assert Q.opt_bytes_per_param() == RQ.opt_bytes_per_param()


def test_opt_state_carries_across():
    """The reference's AdamW and int8 states of a reduced model, carried
    into the port and back, unchanged."""
    rcfg, cfg = ref_reduced("internlm2-1.8b"), get_reduced("internlm2-1.8b")
    rp = jax.device_get(jax.jit(RM.init_model_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(2)))
    p = params_from_numpy(cfg, rp, "cpu")
    rng = np.random.default_rng(4)
    ropt = {k: jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), rp)
        for k in ("m", "v")}
    opt = opt_state_from_numpy(cfg, ropt, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), opt) == jax.tree.map(
        lambda a: a.shape, {k: rp for k in ("m", "v")})
    for a, b in zip(jax.tree.leaves(tree_to_numpy(opt)),
                    jax.tree.leaves(ropt)):
        np.testing.assert_array_equal(a, b)
    rq8 = jax.device_get(jax.jit(RQ.init_opt_state_q8)(rp))
    rq8 = jax.tree.map(lambda a: rng.integers(-127, 128, a.shape).astype(
        a.dtype) if a.dtype == np.int8 else rng.random(a.shape).astype(
        a.dtype), rq8)
    q8 = opt_state_q8_from_numpy(cfg, rq8, "cpu")
    for a, b in zip(jax.tree.leaves(tree_to_numpy(q8)),
                    jax.tree.leaves(rq8)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert T.tree_size(Q.init_opt_state_q8(p)) == sum(
        a.size for a in jax.tree.leaves(rq8))
    with pytest.raises(ValueError, match="shape"):
        opt_state_from_numpy(cfg, {"m": ropt["m"], "v": jax.tree.map(
            lambda a: a[..., :1], ropt["v"])}, "cpu")
