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


def _phase_step_case(rng, R, W, caps, mask="sparse", dead=True):
    """The reference test's generator (tests/test_directory.py), one bool
    plane per region with its own cap: live rows at random sorted bases,
    ragged windows, base = -1 dead rows, INT32_MAX padding of the sorted
    bounds, and a random row mask (``mask="sparse"``), every row
    (``"all"``, passed to the reference as ones) or ``None`` (the port's
    every-row form).  Returns the port's operands (planes, geoms,
    rowmask) as tensors and the reference's (bits (R, W, nw) packed with
    ``pack_mask_rows``, base, rowmask, sbases, sends) as arrays."""
    nw = max(-(-c // 32) for c in caps)
    bits = np.zeros((R, W, nw), np.uint32)
    base = np.full((R, W), -1, np.int32)
    sbs = np.full((R, W), I32MAX, np.int32)
    ses = np.full((R, W), I32MAX, np.int32)
    planes = []
    for r, C in enumerate(caps):
        nlive = int(rng.integers(1, W + 1)) if dead else W
        rows = rng.choice(W, nlive, replace=False)
        b = np.sort(rng.integers(0, 5000, nlive)).astype(np.int32)
        ln = rng.integers(1, C + 1, nlive).astype(np.int32)
        base[r, rows] = b
        sbs[r, :nlive] = np.sort(b)
        ses[r, :nlive] = np.sort(b + ln)
        plane = np.zeros((W, C), bool)
        for i, w in enumerate(rows):
            plane[w, :ln[i]] = rng.random(int(ln[i])) < 0.4
        pk = ref_ps.pack_mask_rows(plane)
        bits[r, :, :pk.shape[1]] = pk
        planes.append(plane)
    rowmask = (rng.random((R, W)) < 0.8 if mask == "sparse"
               else np.ones((R, W), bool))
    geoms = [torch.from_numpy(np.stack([base[r], sbs[r], ses[r]]))
             for r in range(R)]
    port = ([torch.from_numpy(pl) for pl in planes], geoms,
            None if mask is None else torch.from_numpy(rowmask))
    return port, (bits, base, rowmask, sbs, ses)


def _check_phase_step(port, ref):
    counts, shared = ps.phase_step_dense(*port)
    want_c, want_s = ref_ps._phase_step_np(*ref)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(u32(shared), want_s)
    jit_c, jit_s = ref_ps.phase_step(*ref)
    np.testing.assert_array_equal(counts.numpy(), jit_c)
    np.testing.assert_array_equal(u32(shared), jit_s)
    return want_s


@pytest.mark.parametrize("trial", range(4))
def test_phase_step_matches_numpy_and_jit(trial):
    """Random regions of different caps (rarely a multiple of 16), bool
    planes packed by the plain version, against the reference's numpy
    oracle and its jitted chain over the stacked ``pack_mask_rows``
    words."""
    rng = np.random.default_rng(41 + trial)
    R, W = 3, int(rng.integers(1, 9))
    caps = [int(c) for c in rng.integers(1, 200, R)]
    _check_phase_step(*_phase_step_case(rng, R, W, caps))


@pytest.mark.parametrize("R,W,caps,mask", [
    (1, 1, (40,), "sparse"),                 # W = 1
    (2, 1, (7, 33), None),
    (3, 5, (17, 100, 161), None),            # caps not a multiple of 16
    (2, 9, (64, 96), "all"),                 # whole words, every row
    (4, 16, (31, 32, 33, 1), "sparse"),
    (2, 37, (515, 1000), None),
], ids=lambda v: str(v))
def test_phase_step_edges_match_numpy_and_jit(R, W, caps, mask):
    rng = np.random.default_rng(R * 100 + W + sum(caps))
    _check_phase_step(*_phase_step_case(rng, R, W, list(caps), mask))


def test_phase_step_breakpoints_inside_words():
    """Windows that start and end inside 32-page words: the candidate
    words are neither all nor none of their dirty bits."""
    W, C = 4, 100
    base = np.array([0, 10, 45, 70], np.int32)
    ln = np.array([100, 50, 30, 5], np.int32)
    plane = np.zeros((W, C), bool)
    for w in range(W):
        plane[w, :ln[w]] = True
    geom = np.stack([base, np.sort(base), np.sort(base + ln)])
    port = ([torch.from_numpy(plane)], [torch.from_numpy(geom)], None)
    ref = (ref_ps.pack_mask_rows(plane)[None], base[None],
           np.ones((1, W), bool), geom[1][None], geom[2][None])
    shared = _check_phase_step(port, ref)
    dirty = ref[0]
    partial = (shared != 0) & (shared != dirty)
    assert partial.sum() >= 2


def test_phase_step_candidates_in_flush_order():
    """``read_phase_step`` + ``candidate_cells`` give the candidate cells
    region-major, row-major and column-ascending, as a row-major
    nonzero over the reference's unpacked shared plane; with more
    candidate words than ``PHASE_STEP_PREFIX`` (all windows over the
    same pages), so the second copy runs."""
    rng = np.random.default_rng(17)
    port, ref = _phase_step_case(rng, 3, 6, [90, 301, 47])
    W, C = 64, 4096
    dense = rng.random((W, C)) < 0.9
    geom = np.stack([np.zeros(W, np.int32), np.zeros(W, np.int32),
                     np.full(W, C, np.int32)])
    for planes, geoms in ((port[0], port[1]),
                          ([torch.from_numpy(dense)],
                           [torch.from_numpy(geom)])):
        R = len(planes)
        counts, key, word = ps.read_phase_step(
            ps.phase_step(planes, geoms), R, W if R == 1 else 6)
        reg, rows, cols = ps.candidate_cells(key, word, planes[0].shape[0])
        _, want = ps.phase_step_dense(planes, geoms)
        want = u32(want)
        want_cells = np.nonzero(np.stack([
            ref_ps.unpack_mask_rows(want[r], want.shape[2] * 32)
            for r in range(R)]))
        for got, exp in zip((reg, rows, cols), want_cells):
            np.testing.assert_array_equal(got, exp)
    assert key.size > ps.PHASE_STEP_PREFIX


def _multi_mask_walk(sb, se, P):
    """The kernel's per-word stab (``multi_mask`` in
    csrc/protocol_sweep.cu) in Python: two upper_bounds at P, then a walk
    over the bounds below P + 32."""
    W = len(sb)
    i = int(np.searchsorted(sb, P, "right"))
    j = int(np.searchsorted(se, P, "right"))
    cur, mask = P, 0
    while True:
        nxt = min(sb[i] if i < W else 1 << 62, se[j] if j < W else 1 << 62)
        stop = min(nxt, P + 32)
        if i - j >= 2:
            mask |= ((1 << (stop - P)) - 1) & ~((1 << (cur - P)) - 1)
        if nxt >= P + 32:
            return mask
        while i < W and sb[i] == nxt:
            i += 1
        while j < W and se[j] == nxt:
            j += 1
        cur = nxt


def test_read_phase_step_refuses_more_entries_than_words():
    """An ``out`` whose n exceeds the room for entries (one a word: what
    counters left stale on the card would give) raises in place of
    reading past the entries the kernel wrote."""
    rng = np.random.default_rng(3)
    inp = ps.phase_step_inputs(rng, 2, 5, (70, 33), "cpu", True, False)
    out = ps.phase_step(*inp)
    room = (out.shape[0] - 2 * 5 - 1) // 2
    assert room == 5 * (3 + 2)
    ps.read_phase_step(out, 2, 5)
    out[2 * 5] = room + 1
    with pytest.raises(RuntimeError, match="stale"):
        ps.read_phase_step(out, 2, 5)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("length", (40, 400))
def test_word_stab_model_matches_per_page_stab(seed, length):
    """The kernel's per-word coverage mask (``multi_mask``, modelled in
    Python) equals the reference's per-page searchsorted stab on every
    word: dense bounds with duplicates, empty windows and INT32_MAX pads;
    windows up to ``length`` pages long, so a word holds several
    breakpoints (40) or lies deep inside stacked windows (400)."""
    rng = np.random.default_rng(seed)
    W = 24
    nlive = 20
    b = rng.integers(0, 300, nlive)
    e = b + rng.integers(0, length, nlive)
    sb = np.full(W, I32MAX, np.int64)
    se = np.full(W, I32MAX, np.int64)
    sb[:nlive], se[:nlive] = np.sort(b), np.sort(e)
    for P in range(-40, 380 + length, 3):
        pages = P + np.arange(32)
        cov = (np.searchsorted(sb, pages, "right")
               - np.searchsorted(se, pages, "right"))
        want = int(((cov >= 2).astype(np.int64) << np.arange(32)).sum())
        assert _multi_mask_walk(sb, se, P) == want, P


def test_unaligned_word_model():
    """The kernel's byte-to-bit gather (``nibble``/``bits16`` and the
    48-bit shift of ``load_word``) in numpy equals packing the 32 bytes
    directly, at every misalignment, for bytes other than 0 and 1."""
    rng = np.random.default_rng(5)
    buf = rng.choice(np.array([0, 0, 1, 2, 255], np.uint8), 48 * 64)

    def nibble(x):
        m = np.where(x.view(np.uint8).reshape(-1, 4) != 0, 1, 0)
        m = (m.astype(np.uint64) << (8 * np.arange(4, dtype=np.uint64))
             ).sum(axis=1)
        return ((m * 0x01020408) & 0xFFFFFFFF) >> 24

    def bits16(chunk):
        n = nibble(chunk.view(np.uint32))
        return int(sum(int(n[i]) << (4 * i) for i in range(4)))

    for t in range(64):
        for s in range(16):
            q = buf[48 * t:48 * t + 48]
            m = (bits16(q[:16]) | bits16(q[16:32]) << 16
                 | bits16(q[32:]) << 32)
            want = sum(int(q[s + j] != 0) << j for j in range(32))
            assert (m >> s) & 0xFFFFFFFF == want


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: the launch
    counters (which count kernel launches only) stay put."""
    before = dict(ps.LAUNCHES)
    plane = torch.ones((4, 40), dtype=torch.bool)
    bits = ps.pack_rows(plane)
    ps.popcount_rows(bits)
    ps.coverage_multi(torch.tensor([1, 1, -1, -1], dtype=torch.int32))
    ps.phase_step([plane], [torch.zeros((3, 4), dtype=torch.int32)])
    assert ps.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: ps.pack_rows(torch.ones((2, 3), dtype=torch.int32)),
    lambda: ps.popcount_rows(torch.ones(3, dtype=torch.int32)),
    lambda: ps.coverage_multi(torch.ones(3, dtype=torch.int64)),
    lambda: ps.pack_rows(torch.ones((2, 40), dtype=torch.bool),
                         out=torch.zeros((2, 1), dtype=torch.int32)),
    lambda: ps.phase_step([torch.zeros((2, 40), dtype=torch.bool)],
                          [torch.zeros((3, 3), dtype=torch.int32)]),
    lambda: ps.phase_step([torch.zeros((2, 40), dtype=torch.bool),
                           torch.zeros((3, 40), dtype=torch.bool)],
                          [torch.zeros((3, 2), dtype=torch.int32)] * 2),
    lambda: ps.phase_step([torch.zeros((2, 40), dtype=torch.int32)],
                          [torch.zeros((3, 2), dtype=torch.int32)]),
    lambda: ps.phase_step([torch.zeros((2, 40), dtype=torch.bool)],
                          [torch.zeros((3, 2), dtype=torch.int32)],
                          torch.ones((2, 2), dtype=torch.bool)),
])
def test_wrappers_reject_bad_operands(call):
    with pytest.raises((TypeError, ValueError)):
        call()
