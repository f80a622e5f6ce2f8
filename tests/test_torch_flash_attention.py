"""The port's ``flash_attention`` wrapper on the CPU (its plain version)
against the reference's Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it, and against the reference's oracle
``ref.flash_attention_ref`` where the Pallas kernel cannot go (S not a
multiple of its blocks).  Inputs are made with numpy from a seed and
handed to both; bfloat16 inputs are rounded once on each side from the
same float32 values (both round to nearest even).

Tolerances are ``tests/test_kernels.py``'s: 2e-5 (absolute and relative)
in float32, where the two differ only in the order of the f32 sums of an
online against a materialised softmax, and 2e-2 in bfloat16, where the
Pallas kernel rounds the probabilities to bfloat16 before the P.V product
and the plain version does not.

The CUDA kernel's arithmetic has plain models here too:
``flash_attention_tf32_products`` (float32 products as three split-TF32
products, online softmax over 32-key tiles) is held within 2e-5 of the
Pallas kernel and the oracle, where a single TF32 product is not; and
``flash_attention_bf16_products`` (bfloat16 products, p as two bfloat16
terms in P.V) within the card's bfloat16 check of the plain version
(rtol 8e-3 / atol 2e-3) and 2e-2 of the Pallas kernel; p rounded once,
as the Pallas kernel takes it, misses the card's check where a row sees
only a few keys."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.ops import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def _inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def _both(arrs, dtype):
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 4, 256, 64),     # MHA
    (2, 4, 2, 128, 32),     # GQA
    (1, 4, 1, 256, 64),     # MQA
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas(B, Hq, Hkv, S, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(0, B, Hq, Hkv, S, D), dtype)
    want = pallas_flash(jq, jk, jv, q_block=64, kv_block=64, interpret=True)
    got = fa.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == (B, Hq, S, D)
    _close(got, want.astype(jnp.float32), 2e-2 if dtype == "bf16" else 2e-5)


@pytest.mark.parametrize("window", [None, 64, 128])
def test_plain_window_softcap_matches_pallas(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 1, 2, 2, 256, 32), "f32")
    want = pallas_flash(jq, jk, jv, window=window, softcap=30.0, q_block=64,
                        kv_block=64, interpret=True)
    got = fa.flash_attention(tq, tk, tv, window=window, softcap=30.0)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("S", [1, 7, 100, 333])
@pytest.mark.parametrize("kw", [
    {}, {"causal": False}, {"window": 16, "softcap": 50.0},
    {"scale": 144.0 ** -0.5}, {"causal": False, "window": 5}])
def test_plain_ragged_matches_oracle(S, kw):
    """Any S (the Pallas kernel needs S % block == 0): the oracle."""
    arrs = _inputs(2, 2, 4, 2, S, 16)
    want = ref.flash_attention_ref(*arrs, **kw)
    got = fa.flash_attention(*map(torch.from_numpy, arrs), **kw)
    _close(got, want, 2e-5)


def test_strided_model_layout_and_counts():
    """(B, S, H, D) activations passed as transposed views give the result
    of contiguous (B, H, S, D) operands; each call counts in CALLS and,
    on the CPU, never in LAUNCHES."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 2, 4, 2, 40, 16))
    calls, launches = fa.CALLS["flash_attention"], dict(fa.LAUNCHES)
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v)]
    torch.testing.assert_close(fa.flash_attention(*strided),
                               fa.flash_attention(q, k, v), rtol=0, atol=0)
    assert fa.CALLS["flash_attention"] == calls + 2
    assert fa.LAUNCHES == launches


def test_bad_operands_raise():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 4, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k[:, :1].expand(1, 3, 8, 16).contiguous(),
                           v[:, :1].expand(1, 3, 8, 16).contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="q is"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="4-D"):
        fa.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="softcap"):
        fa.flash_attention(q, k, v, softcap=-1.0)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,kw", [
    (1, 2, 1, 128, 128, {}),                               # GQA, D=128
    (2, 4, 2, 128, 16, {}),                                # D=16
    (1, 4, 2, 128, 32, {"window": 64, "softcap": 50.0}),
    (2, 4, 2, 100, 16, {"window": 16, "softcap": 30.0}),   # ragged S
    (1, 2, 1, 333, 128, {}),                               # ragged, D=128
])
def test_three_tf32_products_meet_the_check(B, Hq, Hkv, S, D, kw):
    """The float32 kernel's split, hi*hi + hi*lo + lo*hi on TF32 operands
    over 32-key tiles, stays within the 2e-5 the kernel is held to, of
    the oracle and (where its blocks divide S) of the Pallas kernel; a
    single TF32 product does not, which is why the kernel takes three."""
    arrs = _inputs(5, B, Hq, Hkv, S, D)
    args = list(map(torch.from_numpy, arrs))
    want = ref.flash_attention_ref(*arrs, **kw)
    three = fa.flash_attention_tf32_products(*args, **kw)
    assert three.dtype == torch.float32 and three.shape == (B, Hq, S, D)
    _close(three, want, 2e-5)
    if S % 64 == 0:
        (jq, jk, jv), _ = _both(arrs, "f32")
        _close(three, pallas_flash(jq, jk, jv, q_block=64, kv_block=64,
                                   interpret=True, **kw), 2e-5)
    one = fa.flash_attention_tf32_products(*args, products=1, **kw)
    want = torch.from_numpy(np.array(want, np.float32))
    assert not torch.allclose(one, want, rtol=2e-5, atol=2e-5)
    err1 = float((one - want).abs().max())
    err3 = float((three - want).abs().max())
    assert err3 < 2e-5 < err1 and err1 > 100 * err3


@pytest.mark.parametrize("seed,B,Hq,Hkv,S,D,kw", [
    (6, 1, 2, 1, 128, 128, {}),
    (6, 2, 4, 2, 128, 32, {"window": 64, "softcap": 50.0}),
    (6, 1, 4, 1, 256, 64, {}),
    (6, 2, 4, 2, 100, 16, {"window": 16, "softcap": 30.0}),   # ragged S
    (7, 2, 4, 2, 128, 64, {"scale": 0.1, "window": 3}),
])
def test_bf16_model_meets_the_checks(seed, B, Hq, Hkv, S, D, kw):
    """The bfloat16 kernel's arithmetic (p as two bfloat16 terms in P.V)
    meets the card's check against the plain version, rtol 8e-3 / atol
    2e-3, and tests/test_kernels.py's 2e-2 against the Pallas kernel
    (where its blocks divide S), as does p rounded once, the Pallas
    kernel's own arithmetic."""
    arrs = _inputs(seed, B, Hq, Hkv, S, D)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "bf16")
    got = fa.flash_attention_bf16_products(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, S, D)
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(tq, tk, tv, **kw).float(),
        rtol=8e-3, atol=2e-3)
    if S % 64 == 0:
        want = pallas_flash(jq, jk, jv, q_block=64, kv_block=64,
                            interpret=True, **kw).astype(jnp.float32)
        _close(got, want, 2e-2)
        once = fa.flash_attention_bf16_products(tq, tk, tv, p_terms=1, **kw)
        _close(once, want, 2e-2)


def test_bf16_p_rounded_once_misses_the_card_check():
    """Where a row sees only a few keys (window 3), p rounded once to
    bfloat16 before P.V, as the Pallas kernel does, puts the result a
    bfloat16 ulp outside rtol 8e-3 / atol 2e-3 of the plain version (7.8e-3
    at a value below 0.73); p as two bfloat16 terms, as the kernel takes
    it, does not."""
    kw = {"scale": 0.1, "window": 3}
    tq, tk, tv = _both(_inputs(7, 2, 4, 2, 128, 64), "bf16")[1]
    plain = fa.flash_attention_plain(tq, tk, tv, **kw).float()
    once = fa.flash_attention_bf16_products(tq, tk, tv, p_terms=1, **kw)
    two = fa.flash_attention_bf16_products(tq, tk, tv, **kw)
    assert not torch.allclose(once.float(), plain, rtol=8e-3, atol=2e-3)
    assert torch.allclose(two.float(), plain, rtol=8e-3, atol=2e-3)
