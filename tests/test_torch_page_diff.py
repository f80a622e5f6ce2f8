"""The page_diff kernels' plain versions (the CPU tier of ``diff_encode``,
``diff_apply`` and the in-place merges ``diff_apply_`` and
``diff_apply_rows_``) against the reference's Pallas kernels, run in
interpret mode as ``tests/test_kernels.py`` runs them, against the
reference's jnp oracles (``repro.kernels.ref``) and, at shapes the
Pallas grid refuses, against a numpy oracle.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: exact, on the 32-bit patterns (the kernels have memcmp
semantics and copy values as bits)."""
import numpy as np
import pytest
import torch

import chip_smoke
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


def _numpy_bounds(curr, twin):
    changed = _bits(curr) != _bits(twin)
    w = changed.shape[1]
    anyc = changed.any(1)
    first = np.where(anyc, changed.argmax(1), w)
    last = np.where(anyc, w - 1 - changed[:, ::-1].argmax(1), -1)
    return np.stack([changed.sum(1), first, last]).astype(np.int32)


@pytest.mark.parametrize("case", chip_smoke.BOUNDS_CASES)
@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("w", [256, 1001])
def test_encode_bounds_match_oracle(case, n, w):
    """``diff_encode(..., bounds=True)``: mask and vals as without the
    option, and an int32 (3, n) block of count, first changed word (W
    where none) and last changed word (-1 where none), bit-equal to a
    numpy oracle."""
    curr, twin = chip_smoke.page_diff_bounds_inputs(
        np, np.random.default_rng(n * 11 + w), case, n, w)
    ct, tt = torch.from_numpy(curr), torch.from_numpy(twin)
    mask, vals, stats = diff_encode(ct, tt, bounds=True)
    plain = diff_encode(ct, tt)
    assert stats.dtype == torch.int32 and stats.shape == (3, n)
    np.testing.assert_array_equal(stats.numpy(), _numpy_bounds(curr, twin))
    np.testing.assert_array_equal(stats[0].numpy(), plain[2].numpy())
    np.testing.assert_array_equal(mask.numpy(), plain[0].numpy())
    np.testing.assert_array_equal(_bits(vals.numpy()),
                                  _bits(plain[1].numpy()))
    if case == "none":
        assert stats[1].tolist() == [w] * n and stats[2].tolist() == [-1] * n
    elif case in ("first", "last"):
        at = 0 if case == "first" else w - 1
        assert stats.tolist() == [[1] * n, [at] * n, [at] * n]


def test_empty_and_bad_operands():
    pd.reset_launches()
    mask, vals, count = diff_encode(torch.zeros(0, 64), torch.zeros(0, 64))
    assert mask.shape == (0, 64) and vals.shape == (0, 64)
    assert count.shape == (0,)
    assert diff_apply(torch.zeros(0, 8), torch.zeros(0, 8, dtype=torch.int8),
                      torch.zeros(0, 8)).shape == (0, 8)
    # each wrapper call counts once on any device, empty ones too
    assert pd.CALLS == {"diff_encode": 1, "diff_apply": 1, "diff_apply_": 0,
                        "diff_apply_rows_": 0}
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
    assert pd.LAUNCHES == {"diff_encode": 0, "diff_apply": 0,
                           "diff_apply_": 0, "diff_apply_rows_": 0}


def _merge_inputs(seed: int, n: int, w: int):
    """dst and vals (n, w) float32 with every edge bit pattern among the
    values (-0.0, NaN payloads, denormals), and a mask of 0, 1, -1 and 2
    bytes."""
    rng = np.random.default_rng(seed)
    dst = rng.standard_normal((n, w)).astype(np.float32)
    vals = rng.standard_normal((n, w)).astype(np.float32)
    mask = rng.choice(np.array([0, 0, 0, 1, -1, 2], np.int8), (n, w))
    vb, db = vals.view(np.int32), dst.view(np.int32)
    for k, (v, d) in enumerate([(0x80000000, 0x00000000),
                                (0x7FC00001, 0x7FC00002),
                                (0x00000001, 0x80000000),
                                (0x807FFFFF, 0x7F800000)]):
        i, j = k % n, (5 * k + 1) % w
        vb[i, j] = np.uint32(v).view(np.int32)
        db[i, j] = np.uint32(d).view(np.int32)
        mask[i, j] = (1, -1, 2, 1)[k]                  # the edge words set
    return dst, mask, vals


@pytest.mark.parametrize("n,w", SHAPES + [(5, 1001), (3, 4), (1, 1)])
def test_apply_inplace_matches_functional_and_pallas(n, w):
    """``diff_apply_`` writes into ``dst`` exactly what ``diff_apply``
    returns, bit for bit, and what the Pallas kernel (interpret mode)
    returns where its grid takes the shape; a single page (W,) too."""
    dst, mask, vals = _merge_inputs(n * 3 + w, n, w)
    want = diff_apply(*(torch.from_numpy(a) for a in (dst, mask, vals)))
    got = torch.from_numpy(dst.copy())
    out = pd.diff_apply_(got, torch.from_numpy(mask), torch.from_numpy(vals))
    assert out is got
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(ref.diff_apply_ref(dst, mask, vals)))
    if (n, w) in SHAPES:
        np.testing.assert_array_equal(
            _bits(got.numpy()),
            _bits(np.asarray(jax_apply(dst, mask, vals, interpret=True))))
    page = torch.from_numpy(dst[-1].copy())
    pd.diff_apply_(page, torch.from_numpy(mask[-1]),
                   torch.from_numpy(vals[-1]))
    np.testing.assert_array_equal(_bits(page.numpy()),
                                  _bits(want[-1].numpy()))
    single = diff_apply(torch.from_numpy(dst[0]), torch.from_numpy(mask[0]),
                        torch.from_numpy(vals[0]))
    np.testing.assert_array_equal(_bits(single.numpy()),
                                  _bits(want[0].numpy()))


@pytest.mark.parametrize("n_home,rows", [(16, [0, 3, 4, 15]), (8, [5]),
                                         (32, list(range(0, 32, 2))),
                                         (8, list(range(8)))])
@pytest.mark.parametrize("w", [256, 1001])
def test_apply_rows_matches_gather_apply_scatter(n_home, rows, w):
    """``diff_apply_rows_`` merges row i of mask/vals into home[rows[i]]
    in place: bit-equal to gathering the rows, merging them with the
    functional plain version and the Pallas kernel (interpret mode, at
    the shapes its grid takes) and scattering them back; rows not named
    keep their bits."""
    n = len(rows)
    home_np, mask, vals = _merge_inputs(n_home + w, n_home, w)
    _, mask, vals = _merge_inputs(n + w + 1, n, w)
    home = torch.from_numpy(home_np.copy())
    idx = torch.tensor(rows, dtype=torch.int64)
    want = home.clone()
    want[idx] = diff_apply(home[idx], torch.from_numpy(mask),
                           torch.from_numpy(vals))
    out = pd.diff_apply_rows_(home, idx, torch.from_numpy(mask),
                              torch.from_numpy(vals))
    assert out is home
    np.testing.assert_array_equal(_bits(home.numpy()), _bits(want.numpy()))
    if w % 128 == 0 and (n < 8 or n % 8 == 0):
        merged = np.asarray(jax_apply(home_np[rows], mask, vals,
                                      interpret=True))
        np.testing.assert_array_equal(_bits(home.numpy()[rows]),
                                      _bits(merged))
    others = np.setdiff1d(np.arange(n_home), rows)
    np.testing.assert_array_equal(_bits(home.numpy()[others]),
                                  _bits(home_np[others]))


def test_inplace_merges_empty_and_bad_operands():
    pd.reset_launches()
    e = torch.zeros(0, 8)
    em = torch.zeros(0, 8, dtype=torch.int8)
    assert pd.diff_apply_(e, em, e) is e
    home = torch.zeros(4, 8)
    assert pd.diff_apply_rows_(home, torch.zeros(0, dtype=torch.int64), em,
                               e) is home
    assert pd.CALLS["diff_apply_"] == 1 and pd.CALLS["diff_apply_rows_"] == 1
    m = torch.ones(2, 8, dtype=torch.int8)
    v = torch.ones(2, 8)
    with pytest.raises(TypeError, match="int8"):
        pd.diff_apply_(torch.zeros(2, 8), m.bool(), v)
    with pytest.raises(TypeError, match="float32"):
        pd.diff_apply_(torch.zeros(2, 8, dtype=torch.float64), m, v)
    with pytest.raises(ValueError, match="shape"):
        pd.diff_apply_(torch.zeros(2, 9), m, v)
    with pytest.raises(ValueError, match="contiguous"):
        pd.diff_apply_(torch.zeros(8, 2).t(), m, v)
    with pytest.raises(ValueError, match=r"\(W,\) or pages"):
        pd.diff_apply_(torch.zeros(1, 2, 8), m[None], v[None])
    for rows in ([1, 1], [2, 1], [3, 4], [-1, 0]):
        with pytest.raises(ValueError, match="sorted, unique"):
            pd.diff_apply_rows_(home, torch.tensor(rows), m, v)
    with pytest.raises(TypeError, match="int64"):
        pd.diff_apply_rows_(home, torch.tensor([0, 1], dtype=torch.int32),
                            m, v)
    with pytest.raises(ValueError, match="shape"):
        pd.diff_apply_rows_(home, torch.tensor([0, 1, 2]), m, v)
    with pytest.raises(ValueError, match="shape"):
        pd.diff_apply_rows_(torch.zeros(4, 9), torch.tensor([0, 1]), m, v)
    assert torch.equal(home, torch.zeros(4, 8))
    # the CPU tier never counts a launch
    assert all(v == 0 for v in pd.LAUNCHES.values())
