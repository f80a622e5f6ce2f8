"""The port's ``ssd_chunk`` wrapper on the CPU (its plain version) against
the reference's Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it, and against the oracle
``ref.ssd_chunk_ref`` for what the port adds (grouped B/C rows, any Q);
and a plain-torch model of the kernel's arithmetic
(``ssd_chunk_tf32_products``: every product on TF32 operands, split in
three or taken once) against both.
Inputs are made with numpy from a seed and handed to both.

Tolerance 1e-4 (absolute and relative), ``tests/test_kernels.py``'s: the
two differ only in the order of f32 sums over Q and N.  With bfloat16
inputs both sides widen the same bfloat16 values to f32 exactly, so the
same tolerance holds."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.ops import ssd_chunk as pallas_ssd  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels._tf32 import _tf32  # noqa: E402


def _softplus(a):
    return np.log1p(np.exp(a))


def _inputs(seed, M, Q, P, N, Mg=None):
    rng = np.random.default_rng(seed)
    Mg = M if Mg is None else Mg
    x = rng.standard_normal((M, Q, P))
    dt = _softplus(rng.standard_normal((M, Q, 1)))
    cum = np.cumsum(-_softplus(rng.standard_normal((M, Q, 1))), axis=1)
    B_ = rng.standard_normal((Mg, Q, N)) * 0.3
    C_ = rng.standard_normal((Mg, Q, N)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, cum, B_, C_)]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("M,Q,P,N", [(4, 64, 32, 64), (2, 128, 64, 128),
                                     (8, 32, 16, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas(M, Q, P, N, dtype):
    arrs = _inputs(0, M, Q, P, N)
    if dtype == "bf16":
        jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
        targs = [torch.from_numpy(a).bfloat16() for a in arrs]
    else:
        jargs, targs = arrs, [torch.from_numpy(a) for a in arrs]
    _close(sc.ssd_chunk(*targs), pallas_ssd(*jargs, interpret=True))


@pytest.mark.parametrize("M,Q,P,N,Mg", [(16, 32, 16, 16, 2), (6, 7, 16, 32, 3),
                                        (4, 1, 16, 16, 4), (80, 40, 16, 16, 1)])
def test_grouped_rows_and_any_q_match_oracle(M, Q, P, N, Mg):
    """B/C rows shared by M // Mg consecutive cells equal the per-cell
    layout with each row repeated; Q need not be a power of two."""
    arrs = _inputs(1, M, Q, P, N, Mg)
    rep = M // Mg
    full = arrs[:3] + [np.repeat(a, rep, axis=0) for a in arrs[3:]]
    _close(sc.ssd_chunk(*map(torch.from_numpy, arrs)),
           ref.ssd_chunk_ref(*full))


def test_counts_and_bad_operands():
    x, dt, cum, B_, C_ = map(torch.from_numpy, _inputs(2, 4, 8, 16, 16))
    calls, launches = sc.CALLS["ssd_chunk"], dict(sc.LAUNCHES)
    sc.ssd_chunk(x, dt, cum, B_, C_)
    assert sc.CALLS["ssd_chunk"] == calls + 1 and sc.LAUNCHES == launches
    with pytest.raises(ValueError, match="divide"):
        sc.ssd_chunk(x, dt, cum, B_[:3], C_[:3])
    with pytest.raises(TypeError, match="x is"):
        sc.ssd_chunk(x, dt, cum, B_.bfloat16(), C_.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sc.ssd_chunk(x.double(), dt, cum, B_.double(), C_.double())
    with pytest.raises(ValueError, match="shape"):
        sc.ssd_chunk(x, dt[:, :4], cum, B_, C_)
    with pytest.raises(ValueError, match="must be"):
        sc.ssd_chunk(x, dt, cum, B_[:, :4], C_[:, :4])
    with pytest.raises(ValueError, match="Q >= 1"):
        sc.ssd_chunk(x[:, :0], dt[:, :0], cum[:, :0], B_[:, :0], C_[:, :0])


@pytest.mark.parametrize("M,rep", [(80, 80), (8, 1)], ids=["grouped", "cell"])
def test_three_tf32_products_meet_the_check(M, rep):
    """At mamba2-2.7b's cell shape (Q=256, P=64, N=128; one B/C row for
    80 heads, and per cell) the kernel's split, hi*hi + hi*lo + lo*hi on
    TF32 operands, stays within the 1e-4 the kernel is held to against
    the f32 plain version and the Pallas kernel; a single TF32 product
    does not, which is why the kernel takes three."""
    arrs = _inputs(3, M, 256, 64, 128, M // rep)
    args = list(map(torch.from_numpy, arrs))
    want = sc.ssd_chunk_plain(*args)
    three = sc.ssd_chunk_tf32_products(*args, products=3)
    _close(three, [w.numpy() for w in want])
    if rep == 1:
        _close(three, pallas_ssd(*arrs, interpret=True))
    one = sc.ssd_chunk_tf32_products(*args, products=1)
    assert not all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                   for g, w in zip(one, want))
    err1 = max(float((g - w).abs().max()) for g, w in zip(one, want))
    err3 = max(float((g - w).abs().max()) for g, w in zip(three, want))
    assert err3 < 1e-4 < err1 and err1 > 100 * err3


def test_tf32_rounding():
    """Round to nearest, ties away from zero, at the 10th mantissa bit;
    infinities and NaN pass as they are."""
    v = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -11, -(1.0 + 3 * 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -23, 3.0, float("inf"),
                      -float("inf"), 2.0 ** -130])
    got = _tf32(v)
    want = [1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -9), 1.0, 3.0,
            float("inf"), -float("inf"), 2.0 ** -130]
    assert got.tolist() == want
    assert torch.isnan(_tf32(torch.tensor([float("nan")]))).all()
