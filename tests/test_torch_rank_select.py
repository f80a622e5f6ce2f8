"""The port's rank-select kernels (``take_first_k``, ``kth_set_index`` and
the fused ``take_and_cut`` of ``repro_torch.kernels.protocol_sweep``)
against the reference's ``repro.kernels.protocol_sweep``.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those versions bit for bit against the reference's numpy tier, its Pallas
tier (interpret mode off-TPU) and its jitted tier, on seeded packed rows
with ragged last words, empty rows and all-ones words, at random ranks and
at the edge ranks: k = 0, k < 0, k equal to and past the row's popcount,
and k = INT32_MAX.  Tolerance: exact (integer results; packed words
compared as uint32 bit patterns).  The CUDA kernels are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
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
    """Packed rows at varied densities, with an all-set row (all-ones
    words: the top bit, negative int32 patterns) and an empty row."""
    plane = rng.random((R, C)) < rng.random((R, 1))
    plane[0] = True
    if R > 2:
        plane[-1] = False
    return ref_ps.pack_mask_rows(plane), plane.sum(axis=1)


def _ranks(rng, tot, C):
    """Random ranks, then the edge ranks row by row."""
    R = tot.size
    return [rng.integers(-3, C + 5, R), np.zeros(R, np.int64),
            np.full(R, -7, np.int64), tot, tot + 1,
            np.maximum(tot - 1, 1), np.full(R, I32MAX, np.int64)]


@pytest.mark.parametrize("R,C", SHAPES)
def test_rank_select_matches_numpy_tier(R, C):
    rng = np.random.default_rng(100 * R + C)
    bits, tot = _rows(rng, R, C)
    bt = as_words(bits)
    for k in _ranks(rng, tot, C):
        k = np.asarray(k, np.int64)
        want_t = ref_ps._take_first_k_np(bits, k)
        want_c = ref_ps._kth_set_index_np(bits, k)
        kt = torch.from_numpy(k)
        got_t = ps.take_first_k(bt, kt)
        got_c = ps.kth_set_index(bt, kt)
        assert got_t.dtype == torch.int32 and got_c.dtype == torch.int64
        np.testing.assert_array_equal(u32(got_t), want_t)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        # every rank here fits int32: the fused call takes int32 ranks
        both_t, both_c = ps.take_and_cut(bt, kt.to(torch.int32))
        np.testing.assert_array_equal(u32(both_t), want_t)
        np.testing.assert_array_equal(both_c.numpy(), want_c)


@pytest.mark.parametrize("R,C", ((9, 64), (37, 1000)))
def test_rank_select_matches_pallas_and_jit_tiers(R, C):
    rng = np.random.default_rng(7 * R + C)
    bits, tot = _rows(rng, R, C)
    bt = as_words(bits)
    # random ranks, then every edge rank at once: row i takes edge i % 7
    edges = np.stack(_ranks(rng, tot, C))
    mixed = edges[np.arange(R) % edges.shape[0], np.arange(R)]
    for k in (edges[0], mixed):
        k = np.asarray(k, np.int64)
        kt = torch.from_numpy(k)
        got_t = u32(ps.take_first_k(bt, kt))
        got_c = ps.kth_set_index(bt, kt).numpy()
        for backend in ("pallas", "pallas-jit"):
            np.testing.assert_array_equal(
                got_t, ref_ps.take_first_k(bits, k, backend=backend))
            np.testing.assert_array_equal(
                got_c, ref_ps.kth_set_index(bits, k, backend=backend))
            t, c = ref_ps.take_and_cut(bits, k, backend=backend)
            np.testing.assert_array_equal(got_t, t)
            np.testing.assert_array_equal(got_c, c)


def test_take_then_unpack_is_the_first_k_live_cells():
    """The mask the eviction engine unpacks: per row, the first k live
    cells, which is a boolean prefix count of the live plane."""
    rng = np.random.default_rng(3)
    live = rng.random((9, 77)) < 0.6
    k = rng.integers(0, 60, 9)
    bits = ps.pack_rows(torch.from_numpy(live))
    got = ps.unpack_rows(ps.take_first_k(bits, torch.from_numpy(k)), 77)
    want = live & (np.cumsum(live, axis=1) <= k[:, None])
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_word_axis_matches_reference():
    bits = np.zeros((3, 0), np.uint32)
    k = np.array([0, 1, 5], np.int64)
    bt, kt = as_words(bits), torch.from_numpy(k)
    assert tuple(ps.take_first_k(bt, kt).shape) == (3, 0)
    np.testing.assert_array_equal(ps.kth_set_index(bt, kt).numpy(),
                                  ref_ps.kth_set_index(bits, k))
    t, c = ps.take_and_cut(bt, kt)
    want_t, want_c = ref_ps.take_and_cut(bits, k)
    assert tuple(t.shape) == want_t.shape
    np.testing.assert_array_equal(c.numpy(), want_c)


def test_cpu_rank_select_launches_nothing():
    before = dict(ps.LAUNCHES)
    bits = ps.pack_rows(torch.ones((2, 40), dtype=torch.bool))
    k = torch.tensor([3, 50])
    ps.take_first_k(bits, k)
    ps.kth_set_index(bits, k)
    ps.take_and_cut(bits, k)
    assert ps.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: ps.take_first_k(torch.zeros((2, 3), dtype=torch.int64),
                            torch.zeros(2, dtype=torch.int64)),
    lambda: ps.take_first_k(torch.zeros((2, 3), dtype=torch.int32),
                            torch.zeros(3, dtype=torch.int64)),
    lambda: ps.kth_set_index(torch.zeros((2, 3), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.float32)),
    lambda: ps.take_and_cut(torch.zeros((2, 3), dtype=torch.int32),
                            torch.zeros((2, 1), dtype=torch.int64)),
    lambda: ps.take_and_cut(torch.zeros((2, 6), dtype=torch.int32)[:, ::2],
                            torch.zeros(2, dtype=torch.int64)),
])
def test_rank_select_rejects_bad_operands(call):
    with pytest.raises((TypeError, ValueError)):
        call()
