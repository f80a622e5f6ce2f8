"""The port's ``ssd_chunk`` wrapper on the CPU (its plain version) against
the reference's Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it, and against the oracle
``ref.ssd_chunk_ref`` for what the port adds (grouped B/C rows, any Q).
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
