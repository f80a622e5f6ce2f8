"""The port's rank-select kernels (``take_first_k``, ``kth_set_index``,
the fused ``take_and_cut`` and the one-run ``take_run`` of
``repro_torch.kernels.protocol_sweep``) against the reference's
``repro.kernels.protocol_sweep``.

The port's kernels read bool run planes as they lie (any row stride) and
write the bool take mask; the reference's TPU kernels take packed words.
On the CPU every wrapper runs its plain PyTorch version over the bool
operands.  These tests hold those versions bit for bit against the
reference's numpy tier, its Pallas tier (interpret mode off-TPU) and its
jitted tier, each composed with ``pack_mask_rows`` before it and
``unpack_mask_rows`` after it, on seeded rows with ragged last words,
empty rows and all-set rows, at random ranks and at the edge ranks: k = 0,
k < 0, k equal to and past the row's count, and k = INT32_MAX.  Also:
strided row views (a column window of a wider plane, every other row),
widths that are no multiple of 16 or 32, ranks by value, the one-run
buffer ``[cut, count, columns]`` against ``np.flatnonzero``, and the
packed plain versions ``_take_first_k_plain`` / ``_kth_set_index_plain``
that chain the port's packed words to the numpy tier.  Tolerance: exact
(integer and bool results; packed words compared as uint32 bit
patterns).  The CUDA kernels are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import protocol_sweep as ref_ps
from repro_torch.kernels import protocol_sweep as ps

I32MAX = np.iinfo(np.int32).max
SHAPES = ((1, 1), (1, 32), (3, 31), (8, 64), (37, 1000), (5, 4097))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def as_words(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int32))


def _rows(rng, R, C):
    """Bool rows at varied densities, with an all-set row (all-ones
    words: the top bit, negative int32 patterns) and an empty row."""
    plane = rng.random((R, C)) < rng.random((R, 1))
    plane[0] = True
    if R > 2:
        plane[-1] = False
    return plane, plane.sum(axis=1)


def _ranks(rng, tot, C):
    """Random ranks, then the edge ranks row by row."""
    R = tot.size
    return [rng.integers(-3, C + 5, R), np.zeros(R, np.int64),
            np.full(R, -7, np.int64), tot, tot + 1,
            np.maximum(tot - 1, 1), np.full(R, I32MAX, np.int64)]


def _want(plane, k):
    """The numpy tier's take (unpacked) and cut."""
    bits = ref_ps.pack_mask_rows(plane)
    return (ref_ps.unpack_mask_rows(ref_ps._take_first_k_np(bits, k),
                                    plane.shape[1]),
            ref_ps._kth_set_index_np(bits, k))


def _check(live, k, plane):
    """All three entries on ``live`` (a tensor holding ``plane``, maybe a
    view) against the numpy tier."""
    k = np.asarray(k, np.int64)
    want_t, want_c = _want(plane, k)
    kt = torch.from_numpy(k)
    got_t = ps.take_first_k(live, kt)
    got_c = ps.kth_set_index(live, kt)
    assert got_t.dtype == torch.bool and got_c.dtype == torch.int64
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    # every rank here fits int32: the fused call takes int32 ranks
    both_t, both_c = ps.take_and_cut(live, kt.to(torch.int32))
    np.testing.assert_array_equal(both_t.numpy(), want_t)
    np.testing.assert_array_equal(both_c.numpy(), want_c)


@pytest.mark.parametrize("R,C", SHAPES)
def test_rank_select_matches_numpy_tier(R, C):
    rng = np.random.default_rng(100 * R + C)
    plane, tot = _rows(rng, R, C)
    bits = ref_ps.pack_mask_rows(plane)
    bt = as_words(bits)
    for k in _ranks(rng, tot, C):
        _check(torch.from_numpy(plane), k, plane)
        # the packed plain versions: the port's packed words against the
        # numpy tier's
        k = np.asarray(k, np.int64)
        kt = torch.from_numpy(k)
        np.testing.assert_array_equal(u32(ps._take_first_k_plain(bt, kt)),
                                      ref_ps._take_first_k_np(bits, k))
        np.testing.assert_array_equal(
            ps._kth_set_index_plain(bt, kt).numpy(),
            ref_ps._kth_set_index_np(bits, k))


@pytest.mark.parametrize("R,C", ((9, 64), (37, 1000)))
def test_rank_select_matches_pallas_and_jit_tiers(R, C):
    rng = np.random.default_rng(7 * R + C)
    plane, tot = _rows(rng, R, C)
    bits = ref_ps.pack_mask_rows(plane)
    live = torch.from_numpy(plane)
    # random ranks, then every edge rank at once: row i takes edge i % 7
    edges = np.stack(_ranks(rng, tot, C))
    mixed = edges[np.arange(R) % edges.shape[0], np.arange(R)]
    for k in (edges[0], mixed):
        k = np.asarray(k, np.int64)
        kt = torch.from_numpy(k)
        got_t = ps.take_first_k(live, kt).numpy()
        got_c = ps.kth_set_index(live, kt).numpy()
        for backend in ("pallas", "pallas-jit"):
            np.testing.assert_array_equal(got_t, ref_ps.unpack_mask_rows(
                ref_ps.take_first_k(bits, k, backend=backend), C))
            np.testing.assert_array_equal(
                got_c, ref_ps.kth_set_index(bits, k, backend=backend))
            t, c = ref_ps.take_and_cut(bits, k, backend=backend)
            np.testing.assert_array_equal(got_t,
                                          ref_ps.unpack_mask_rows(t, C))
            np.testing.assert_array_equal(got_c, c)


def test_take_then_unpack_is_the_first_k_live_cells():
    """The mask the eviction engine takes: per row, the first k live
    cells, a boolean prefix count of the live plane; the packed plain
    version, unpacked, gives the same."""
    rng = np.random.default_rng(3)
    live = rng.random((9, 77)) < 0.6
    k = rng.integers(0, 60, 9)
    want = live & (np.cumsum(live, axis=1) <= k[:, None])
    got = ps.take_first_k(torch.from_numpy(live), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)
    bits = ps.pack_rows(torch.from_numpy(live))
    packed = ps.unpack_rows(
        ps._take_first_k_plain(bits, torch.from_numpy(k)), 77)
    np.testing.assert_array_equal(packed.numpy(), want)


def test_empty_word_axis_matches_reference():
    live = torch.zeros((3, 0), dtype=torch.bool)
    bits = np.zeros((3, 0), np.uint32)
    k = np.array([0, 1, 5], np.int64)
    kt = torch.from_numpy(k)
    assert tuple(ps.take_first_k(live, kt).shape) == (3, 0)
    np.testing.assert_array_equal(ps.kth_set_index(live, kt).numpy(),
                                  ref_ps.kth_set_index(bits, k))
    t, c = ps.take_and_cut(live, kt)
    want_t, want_c = ref_ps.take_and_cut(bits, k)
    assert tuple(t.shape) == want_t.shape
    np.testing.assert_array_equal(c.numpy(), want_c)
    buf = ps.take_run(torch.zeros(0, dtype=torch.bool), 3)
    assert ps.read_take_run(buf)[0] == -1
    assert ps.read_take_run(buf)[1].size == 0


@pytest.mark.parametrize("R,C,offset,pad", [
    (4, 31, 1, 2), (3, 100, 5, 11), (6, 1025, 3, 0), (2, 33, 16, 16),
    (1, 9, 7, 40), (5, 4097, 1, 1)])
def test_strided_row_views_match_numpy_tier(R, C, offset, pad):
    """Rows given by a pointer and a row stride: a column window of a
    wider plane, and every other row of it, read in place."""
    rng = np.random.default_rng(R * C + offset)
    wide = rng.random((2 * R, offset + C + pad)) < 0.4
    wide[0, offset:offset + C] = True
    wt = torch.from_numpy(wide)
    for rows in (slice(0, R), slice(0, 2 * R, 2)):
        live = wt[rows, offset:offset + C]
        assert not live.is_contiguous() or R == 1
        plane = wide[rows, offset:offset + C]
        tot = plane.sum(axis=1)
        for k in _ranks(rng, tot, C):
            _check(live, k, plane)


@pytest.mark.parametrize("C", (1, 7, 16, 17, 31, 32, 33, 1000, 1025))
def test_rank_by_value_matches_rank_vector(C):
    rng = np.random.default_rng(C)
    live = torch.from_numpy(rng.random((1, C)) < 0.5)
    tot = int(live.sum())
    for k in (0, -3, 1, tot, tot + 1, max(tot - 1, 1), C, I32MAX):
        kt = torch.tensor([k], dtype=torch.int64)
        assert torch.equal(ps.take_first_k(live, k),
                           ps.take_first_k(live, kt))
        assert torch.equal(ps.kth_set_index(live, k),
                           ps.kth_set_index(live, kt))
        for a, b in zip(ps.take_and_cut(live, k), ps.take_and_cut(live, kt)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", (True, False))
@pytest.mark.parametrize("C", (1, 2, 7, 9, 31, 32, 33, 1000, 1025))
def test_take_run_matches_flatnonzero(C, fused):
    """The one-run buffer [cut, count, columns]: the columns are
    ``np.flatnonzero(live)[:k]``, the cut the k-th live column (-1 when
    there is none).  The kernel's buffer has room for clamp(k, 0, C)
    columns; the plain version's holds the count it wrote."""
    rng = np.random.default_rng(31 * C + fused)
    live = rng.random(C) < 0.6
    nz = np.flatnonzero(live)
    for k in (0, -2, 1, 2, nz.size, nz.size + 1, max(nz.size - 1, 1), C,
              I32MAX):
        buf = ps.take_run(torch.from_numpy(live), k, fused)
        assert buf.dtype == torch.int64
        cut, cols = ps.read_take_run(buf)
        want = nz[:max(k, 0)]
        np.testing.assert_array_equal(cols, want)
        assert int(buf[1]) == want.size
        assert 2 + want.size <= buf.shape[0] <= 2 + min(max(k, 0), C)
        assert cut == (int(nz[k - 1]) if 1 <= k <= nz.size else -1)


def test_take_run_on_a_plane_row_view():
    """A run as the replay may hand it: a column window of one row of a
    plane, read as it lies."""
    rng = np.random.default_rng(11)
    plane = rng.random((4, 300)) < 0.5
    pt = torch.from_numpy(plane)
    for w, a, b in ((0, 0, 7), (3, 17, 26), (2, 101, 300), (1, 5, 6)):
        row = plane[w, a:b]
        nz = np.flatnonzero(row)
        for k in (1, nz.size, nz.size + 1):
            for fused in (True, False):
                cut, cols = ps.read_take_run(ps.take_run(pt[w, a:b], k,
                                                         fused))
                np.testing.assert_array_equal(cols, nz[:k])
                assert cut == (int(nz[k - 1]) if 1 <= k <= nz.size else -1)


def test_cpu_rank_select_launches_nothing():
    before = dict(ps.LAUNCHES)
    live = torch.ones((2, 40), dtype=torch.bool)
    k = torch.tensor([3, 50])
    ps.take_first_k(live, k)
    ps.kth_set_index(live, k)
    ps.take_and_cut(live, k)
    ps.take_run(live[0], 3)
    ps.take_run(live[1], 3, fused=False)
    assert ps.LAUNCHES == before


def test_take_run_counts_the_calls_of_its_entries():
    """``CALLS`` on the CPU says what the card launches: one take_and_cut
    for a fused victim scan, take_first_k and kth_set_index otherwise."""
    live = torch.ones(9, dtype=torch.bool)
    before = dict(ps.CALLS)
    ps.take_run(live, 2)
    ps.take_run(live, 2, fused=False)
    diff = {k: ps.CALLS[k] - before[k] for k in ps.CALLS}
    assert diff["take_and_cut"] == 1
    assert diff["take_first_k"] == diff["kth_set_index"] == 1
    assert diff["pack_rows"] == 0


@pytest.mark.parametrize("call", [
    lambda: ps.take_first_k(torch.zeros((2, 3), dtype=torch.int64),
                            torch.zeros(2, dtype=torch.int64)),
    lambda: ps.take_first_k(torch.zeros((2, 3), dtype=torch.bool),
                            torch.zeros(3, dtype=torch.int64)),
    lambda: ps.kth_set_index(torch.zeros((2, 3), dtype=torch.bool),
                             torch.zeros(2, dtype=torch.float32)),
    lambda: ps.take_and_cut(torch.zeros((2, 3), dtype=torch.bool),
                            torch.zeros((2, 1), dtype=torch.int64)),
    lambda: ps.take_and_cut(torch.zeros((2, 6), dtype=torch.bool)[:, ::2],
                            torch.zeros(2, dtype=torch.int64)),
    lambda: ps.take_first_k(torch.zeros((2, 3), dtype=torch.bool), 1),
    lambda: ps.take_run(torch.zeros((2, 3), dtype=torch.bool), 1),
    lambda: ps.take_run(torch.zeros(6, dtype=torch.bool)[::2], 1),
])
def test_rank_select_rejects_bad_operands(call):
    with pytest.raises((TypeError, ValueError)):
        call()
