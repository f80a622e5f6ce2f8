"""The page_diff kernels' plain versions (the CPU tier of ``diff_encode``
and ``diff_apply``) against the reference's Pallas kernels, run in
interpret mode as ``tests/test_kernels.py`` runs them, against the
reference's jnp oracles (``repro.kernels.ref``) and, at shapes the
Pallas grid refuses, against a numpy oracle.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: exact, on the 32-bit patterns (the kernels have memcmp
semantics and copy values as bits)."""
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ops import diff_apply as jax_apply
from repro.kernels.ops import diff_encode as jax_encode
from repro_torch.kernels import page_diff as pd
from repro_torch.kernels import diff_apply, diff_encode

SHAPES = [(8, 1024), (16, 256), (32, 1024), (8, 128), (1, 256), (1, 1024)]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _pages(seed: int, n: int, w: int, frac: float = 0.1):
    """twin and curr (n, w) float32: ~frac of the words changed."""
    rng = np.random.default_rng(seed)
    twin = rng.standard_normal((n, w)).astype(np.float32)
    changed = rng.random((n, w)) < frac
    curr = np.where(changed, rng.standard_normal((n, w)).astype(np.float32),
                    twin)
    return curr, twin


def _edge_pages():
    """(4, 256) pages whose every diff is one of the edge bit patterns:
    -0.0 against +0.0, two NaN payloads, equal NaN bits, denormals."""
    twin = np.zeros((4, 256), np.float32)
    curr = twin.copy()
    bits = curr.view(np.int32)
    tbits = twin.view(np.int32)
    curr[0, 7] = -0.0                              # signed zero
    bits[0, 9] = 0x00000001                        # smallest denormal
    bits[1, 3] = 0x7FC00001                        # NaN payloads differ
    tbits[1, 3] = 0x7FC00002
    bits[1, 4] = tbits[1, 4] = 0x7FC00005          # equal NaN bits
    bits[2, 0] = -0x7F800001                       # negative denormal
    twin[3] = 1.0
    curr[3] = 1.0
    bits[3, 255] = 0x3F800001                      # last word, one ulp
    return curr, twin


def _numpy_encode(curr, twin):
    changed = _bits(curr) != _bits(twin)
    vals = np.where(changed, _bits(curr), 0).astype(np.int32)
    return (changed.astype(np.int8), vals.view(np.float32),
            changed.sum(1).astype(np.int32))


def _assert_encode_equal(got, want):
    mask, vals, count = (np.asarray(x) for x in want)
    assert got[0].dtype == torch.int8 and got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), mask)
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(vals))
    np.testing.assert_array_equal(got[2].numpy(), count)


@pytest.mark.parametrize("n,w", SHAPES)
def test_encode_matches_pallas_and_oracle(n, w):
    curr, twin = _pages(n * 7 + w, n, w)
    got = diff_encode(torch.from_numpy(curr), torch.from_numpy(twin))
    _assert_encode_equal(got, jax_encode(curr, twin, interpret=True))
    _assert_encode_equal(got, ref.diff_encode_ref(curr, twin))


@pytest.mark.parametrize("n,w", SHAPES)
def test_apply_matches_pallas_and_oracle(n, w):
    rng = np.random.default_rng(n + w)
    dst = rng.standard_normal((n, w)).astype(np.float32)
    vals = rng.standard_normal((n, w)).astype(np.float32)
    # any nonzero mask byte counts as set: -1, 1 and 2 mixed with 0
    mask = rng.choice(np.array([0, 0, 0, 1, -1, 2], np.int8), (n, w))
    got = diff_apply(*(torch.from_numpy(a) for a in (dst, mask, vals)))
    want = np.asarray(jax_apply(dst, mask, vals, interpret=True))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        _bits(got.numpy()), _bits(ref.diff_apply_ref(dst, mask, vals)))


@pytest.mark.parametrize("n,w", SHAPES)
def test_round_trip_rebuilds_curr(n, w):
    curr, twin = _pages(100 + n + w, n, w, frac=0.3)
    ct, tt = torch.from_numpy(curr), torch.from_numpy(twin)
    mask, vals, _ = diff_encode(ct, tt)
    rebuilt = diff_apply(tt, mask, vals)
    np.testing.assert_array_equal(_bits(rebuilt.numpy()), _bits(curr))


def test_edge_bits_match_pallas():
    curr, twin = _edge_pages()
    got = diff_encode(torch.from_numpy(curr), torch.from_numpy(twin))
    _assert_encode_equal(got, jax_encode(curr, twin, interpret=True))
    assert got[2].tolist() == [2, 1, 1, 1]
    assert not bool(got[0][1, 4])                  # equal NaN bits: no diff
    # vals keep the exact bits of curr, and +0.0 where unchanged
    np.testing.assert_array_equal(_bits(got[1].numpy())[0, [7, 9, 8]],
                                  [np.int32(-2**31), 1, 0])
    rebuilt = diff_apply(torch.from_numpy(twin), got[0], got[1])
    np.testing.assert_array_equal(_bits(rebuilt.numpy()), _bits(curr))
    want = jax_apply(twin, np.asarray(got[0]), np.asarray(got[1]),
                     interpret=True)
    np.testing.assert_array_equal(_bits(rebuilt.numpy()), _bits(want))


@pytest.mark.parametrize("n,w", [(5, 1001), (13, 256), (5, 3), (13, 1024)])
def test_shapes_the_pallas_grid_refuses(n, w):
    """Any n >= 1 and any page width (the Pallas grid needs n % 8 == 0
    once n >= 8): against the numpy oracle and the jnp oracle."""
    curr, twin = _pages(n * 31 + w, n, w, frac=0.2)
    curr[0, 0] = -0.0
    got = diff_encode(torch.from_numpy(curr), torch.from_numpy(twin))
    _assert_encode_equal(got, _numpy_encode(curr, twin))
    _assert_encode_equal(got, ref.diff_encode_ref(curr, twin))
    rebuilt = diff_apply(torch.from_numpy(twin), got[0], got[1])
    np.testing.assert_array_equal(_bits(rebuilt.numpy()), _bits(curr))


def test_empty_and_bad_operands():
    pd.reset_launches()
    mask, vals, count = diff_encode(torch.zeros(0, 64), torch.zeros(0, 64))
    assert mask.shape == (0, 64) and vals.shape == (0, 64)
    assert count.shape == (0,)
    assert diff_apply(torch.zeros(0, 8), torch.zeros(0, 8, dtype=torch.int8),
                      torch.zeros(0, 8)).shape == (0, 8)
    # each wrapper call counts once on any device, empty ones too
    assert pd.CALLS == {"diff_encode": 1, "diff_apply": 1}
    with pytest.raises(TypeError, match="float32"):
        diff_encode(torch.zeros(2, 8, dtype=torch.float64),
                    torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        diff_encode(torch.zeros(2, 8), torch.zeros(2, 9))
    with pytest.raises(TypeError, match="int8"):
        diff_apply(torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.bool),
                   torch.zeros(2, 8))
    with pytest.raises(ValueError, match="contiguous"):
        diff_encode(torch.zeros(8, 2).t(), torch.zeros(2, 8))
    # the CPU tier never counts a launch
    assert pd.LAUNCHES == {"diff_encode": 0, "diff_apply": 0}
