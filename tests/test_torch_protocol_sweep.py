"""Kernel-level parity of the port's protocol-sweep kernels
(``repro_torch.kernels.protocol_sweep``) against the reference
(``repro.kernels.protocol_sweep``).

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those versions bit for bit against the reference's numpy tier, its Pallas
tier (interpret mode off-TPU) and its jitted fused chain, on seeded
inputs with ragged column counts, inactive rows (base = -1), masked rows
and INT32_MAX geometry padding.  Tolerance: exact everywhere (integer
results; packed words compared as uint32 bit patterns).  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import protocol_sweep as ref_ps
from repro_torch.kernels import protocol_sweep as ps

I32MAX = np.iinfo(np.int32).max
SHAPES = ((1, 1), (3, 31), (8, 32), (37, 1000), (256, 513))


def u32(t: torch.Tensor) -> np.ndarray:
    """Packed int32 words -> the reference's uint32 view."""
    return t.numpy().view(np.uint32)


def as_words(bits: np.ndarray) -> torch.Tensor:
    """Reference uint32 words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int32))


@pytest.mark.parametrize("W,C", SHAPES)
def test_pack_unpack_match_reference(W, C):
    rng = np.random.default_rng(W * 1000 + C)
    plane = rng.random((W, C)) < 0.3
    got = ps.pack_rows(torch.from_numpy(plane))
    want = ref_ps.pack_mask_rows(plane)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(ps.unpack_rows(got, C).numpy(),
                                  ref_ps.unpack_mask_rows(want, C))


def test_pack_into_wider_buffer_zero_pads():
    rng = np.random.default_rng(3)
    plane = rng.random((5, 70)) < 0.5
    out = torch.full((5, 7), -1, dtype=torch.int32)
    ps.pack_rows(torch.from_numpy(plane), out=out)
    want = np.zeros((5, 7), np.uint32)
    want[:, :3] = ref_ps.pack_mask_rows(plane)
    np.testing.assert_array_equal(u32(out), want)


@pytest.mark.parametrize("W,C", SHAPES)
def test_popcount_matches_numpy_tier(W, C):
    rng = np.random.default_rng(7 + W + C)
    bits = ref_ps.pack_mask_rows(rng.random((W, C)) < 0.45)
    got = ps.popcount_rows(as_words(bits))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref_ps._popcount_rows_np(bits))


def test_popcount_matches_pallas_and_jit_tiers():
    rng = np.random.default_rng(11)
    # all-ones words exercise the top bit (negative int32 patterns)
    plane = rng.random((41, 700)) < 0.5
    plane[3] = True
    bits = ref_ps.pack_mask_rows(plane)
    got = ps.popcount_rows(as_words(bits)).numpy()
    np.testing.assert_array_equal(
        got, ref_ps.popcount_rows(bits, backend="pallas"))
    np.testing.assert_array_equal(
        got, ref_ps.popcount_rows(bits, backend="pallas-jit"))


@pytest.mark.parametrize("n", (1, 2, 9, 128, 515))
def test_coverage_matches_numpy_and_pallas(n):
    rng = np.random.default_rng(13 + n)
    delta = rng.choice(np.array([1, -1], np.int64), n)
    got = ps.coverage_multi(torch.from_numpy(delta.astype(np.int32)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.cumsum(delta) >= 2)
    np.testing.assert_array_equal(
        got.numpy(), ref_ps.coverage_multi(delta, backend="pallas"))


def _phase_step_case(rng, R, W, C):
    """The reference test's generator (tests/test_directory.py): live rows
    at random sorted bases, ragged windows, random masks, INT32_MAX
    padding of the sorted bounds, base = -1 dead rows."""
    nw = -(-C // 32)
    bits = np.zeros((R, W, nw), np.uint32)
    base = np.full((R, W), -1, np.int32)
    sbs = np.full((R, W), I32MAX, np.int32)
    ses = np.full((R, W), I32MAX, np.int32)
    for r in range(R):
        nlive = int(rng.integers(1, W + 1))
        rows = rng.choice(W, nlive, replace=False)
        b = np.sort(rng.integers(0, 5000, nlive)).astype(np.int32)
        ln = rng.integers(1, C + 1, nlive).astype(np.int32)
        base[r, rows] = b
        sbs[r, :nlive] = np.sort(b)
        ses[r, :nlive] = np.sort(b + ln)
        for i, w in enumerate(rows):
            plane = np.zeros(C, bool)
            plane[:ln[i]] = rng.random(int(ln[i])) < 0.4
            bits[r, w] = ref_ps.pack_mask_rows(plane[None])[0]
    rowmask = rng.random((R, W)) < 0.8
    return bits, base, rowmask, sbs, ses


@pytest.mark.parametrize("trial", range(4))
def test_phase_step_matches_numpy_and_jit(trial):
    rng = np.random.default_rng(41 + trial)
    R, W, C = 3, int(rng.integers(1, 9)), int(rng.integers(1, 200))
    bits, base, rowmask, sbs, ses = _phase_step_case(rng, R, W, C)
    counts, shared = ps.phase_step(
        as_words(bits), torch.from_numpy(base), torch.from_numpy(rowmask),
        torch.from_numpy(sbs), torch.from_numpy(ses))
    want_c, want_s = ref_ps._phase_step_np(bits, base, rowmask, sbs, ses)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(u32(shared), want_s)
    jit_c, jit_s = ref_ps.phase_step(bits, base, rowmask, sbs, ses)
    np.testing.assert_array_equal(counts.numpy(), jit_c)
    np.testing.assert_array_equal(u32(shared), jit_s)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: the launch
    counters (which count kernel launches only) stay put."""
    before = dict(ps.LAUNCHES)
    plane = torch.ones((4, 40), dtype=torch.bool)
    bits = ps.pack_rows(plane)
    ps.popcount_rows(bits)
    ps.coverage_multi(torch.tensor([1, 1, -1, -1], dtype=torch.int32))
    z = torch.zeros((1, 4), dtype=torch.int32)
    ps.phase_step(bits[None], z, torch.ones((1, 4), dtype=torch.bool), z, z)
    assert ps.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: ps.pack_rows(torch.ones((2, 3), dtype=torch.int32)),
    lambda: ps.popcount_rows(torch.ones(3, dtype=torch.int32)),
    lambda: ps.coverage_multi(torch.ones(3, dtype=torch.int64)),
    lambda: ps.pack_rows(torch.ones((2, 40), dtype=torch.bool),
                         out=torch.zeros((2, 1), dtype=torch.int32)),
    lambda: ps.phase_step(torch.zeros((1, 2, 1), dtype=torch.int32),
                          torch.zeros((1, 3), dtype=torch.int32),
                          torch.ones((1, 2), dtype=torch.bool),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.zeros((1, 2), dtype=torch.int32)),
])
def test_wrappers_reject_bad_operands(call):
    with pytest.raises((TypeError, ValueError)):
        call()
