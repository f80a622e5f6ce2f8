"""Kernel-level parity of the port's protocol-sweep kernels
(``repro_torch.kernels.protocol_sweep``) against the reference
(``repro.kernels.protocol_sweep``).

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those versions bit for bit against the reference's numpy tier, its Pallas
tier (interpret mode off-TPU) and its jitted fused chain, on seeded
inputs with ragged column counts, inactive rows (base = -1), masked rows
and INT32_MAX geometry padding; ``popcount_rows`` on bool rows read in
place and ``coverage_multi`` on the sorted int64 bounds against the
reference's packed and delta operands.  Tolerance: exact everywhere (integer
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


def popcount_want(plane: np.ndarray) -> np.ndarray:
    """The reference's numpy tier on host bool rows: packed with
    ``pack_mask_rows``, then ``_popcount_rows_np``."""
    return ref_ps._popcount_rows_np(ref_ps.pack_mask_rows(plane != 0))


@pytest.mark.parametrize("W,C", SHAPES)
def test_popcount_matches_numpy_tier(W, C):
    """``popcount_rows`` on seeded bool planes against the reference's
    ``_popcount_rows_np(pack_mask_rows(plane))``; the packed plain
    version, the chain to that numpy tier, against it too."""
    rng = np.random.default_rng(7 + W + C)
    plane = rng.random((W, C)) < 0.45
    got = ps.popcount_rows(torch.from_numpy(plane))
    assert got.dtype == torch.int64 and tuple(got.shape) == (W,)
    want = popcount_want(plane)
    np.testing.assert_array_equal(got.numpy(), want)
    bits = ref_ps.pack_mask_rows(plane)
    np.testing.assert_array_equal(
        ps._popcount_rows_plain(as_words(bits)).numpy(), want)


def test_popcount_matches_pallas_and_jit_tiers():
    """Bool rows through the port against the packed rows through the
    reference's Pallas kernel (interpret mode) and its jitted tier; an
    all-set row fills every word (negative int32 patterns)."""
    rng = np.random.default_rng(11)
    plane = rng.random((41, 700)) < 0.5
    plane[3] = True
    bits = ref_ps.pack_mask_rows(plane)
    got = ps.popcount_rows(torch.from_numpy(plane)).numpy()
    np.testing.assert_array_equal(
        got, ref_ps.popcount_rows(bits, backend="pallas"))
    np.testing.assert_array_equal(
        got, ref_ps.popcount_rows(bits, backend="pallas-jit"))


def _view_case(rng, case):
    """(port operand, host bool rows it holds) for ``popcount_rows``: a
    column window of a wider plane, every other row of one, mask bytes of
    2 and 0xff, no rows, no columns."""
    wide = rng.random((30, 1100)) < 0.5
    if case == "window":
        return torch.from_numpy(wide)[:, 7:7 + 1041], wide[:, 7:7 + 1041]
    if case == "every_other_row":
        return torch.from_numpy(wide)[::2, 3:700], wide[::2, 3:700]
    if case == "bytes_2_and_ff":
        u8 = rng.choice(np.array([0, 1, 2, 255], np.uint8), (9, 77))
        return torch.from_numpy(u8).view(torch.bool), u8 != 0
    if case == "no_rows":
        return torch.zeros((0, 40), dtype=torch.bool), np.zeros((0, 40), bool)
    assert case == "no_columns"
    return torch.zeros((4, 0), dtype=torch.bool), np.zeros((4, 0), bool)


@pytest.mark.parametrize("case", ["window", "every_other_row",
                                  "bytes_2_and_ff", "no_rows", "no_columns"])
def test_popcount_on_views_and_mask_bytes(case):
    """Rows read as they lie (a column window, every other row: any row
    stride, cells contiguous) and mask bytes other than 1, which count as
    one set cell, against the reference on the same cells."""
    rng = np.random.default_rng(len(case))
    view, plane = _view_case(rng, case)
    got = ps.popcount_rows(view)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), popcount_want(plane))


def _row_split(skew: int, C: int):
    """The cells of a row ``skew`` bytes past a 16-byte boundary as the
    kernel's ``count_row`` splits them: the head up to the boundary, the
    aligned 16-byte chunks, the ragged tail."""
    head = 0 if skew == 0 else min(16 - skew, C)
    chunks = (C - head) >> 4
    tail = head + 16 * chunks
    return range(head), [range(head + 16 * i, head + 16 * i + 16)
                         for i in range(chunks)], range(tail, C)


def test_popcount_row_split_model():
    """``count_row``'s split, modelled in Python: at every misalignment
    and ragged length every cell is counted once, each chunk starts on a
    16-byte boundary, and head and tail have fewer than 16 cells (one a
    thread of a warp); its per-lane nonzero test (``nonzero4``) counts
    bytes of 2 and 0xff as one."""
    for skew in range(16):
        for C in list(range(0, 70)) + [1024, 1041, 16384, 16385]:
            head, chunks, tail = _row_split(skew, C)
            cells = list(head) + [c for ch in chunks for c in ch] + list(tail)
            assert cells == list(range(C)), (skew, C)
            assert all((skew + ch.start) % 16 == 0 for ch in chunks)
            assert len(head) < 16 and len(tail) < 16
    rng = np.random.default_rng(2)
    words = rng.choice(np.array([0, 1, 2, 255], np.uint8), (500, 4))
    lanes = words.copy().view(np.uint32).reshape(-1)
    for w, x in zip(words, lanes):
        vcmpne = sum(1 << (8 * i) for i in range(4)
                     if (int(x) >> (8 * i)) & 0xFF)
        assert bin(vcmpne & 0x01010101).count("1") == int((w != 0).sum())


def coverage_bounds(rng, n: int, span: int = 0, length: int = 20,
                    base: int = 0):
    """n seeded windows as the directory holds them: sorted starts and
    sorted ends, int64; starts drawn from ``span`` values (4n when 0), so
    ties are common, and lengths from [0, ``length``), so some windows
    are empty (a start equal to an end), offset by ``base``."""
    starts = base + rng.integers(0, span or max(4 * n, 1), n)
    ends = starts + rng.integers(0, length, n)
    return np.sort(starts).astype(np.int64), np.sort(ends).astype(np.int64)


def coverage_want(starts, ends, backend="numpy"):
    """The reference's sweep: the concatenated bounds' stable argsort,
    the points in that order and the reference's ``coverage_multi`` of
    the ordered deltas (``backend`` its tier)."""
    pts = np.concatenate([starts, ends])
    delta = np.concatenate([np.ones(starts.size, np.int64),
                            np.full(ends.size, -1, np.int64)])
    order = np.argsort(pts, kind="stable")
    return pts[order], ref_ps.coverage_multi(delta[order], backend=backend)


def check_coverage(starts, ends, backends=("numpy",)):
    n = starts.size
    buf = ps.coverage_multi(torch.from_numpy(np.stack([starts, ends])))
    assert buf.dtype == torch.int64 and tuple(buf.shape) == (4 * n,)
    buf = buf.numpy()
    assert set(np.unique(buf[2 * n:])) <= {0, 1}
    for backend in backends:
        pts, multi = coverage_want(starts, ends, backend)
        np.testing.assert_array_equal(buf[:2 * n], pts)
        np.testing.assert_array_equal(buf[2 * n:] != 0, multi)


@pytest.mark.parametrize("n", (1, 2, 9, 128, 515))
def test_coverage_matches_numpy_and_pallas(n):
    """Seeded sorted bounds of n windows (ties, empty windows) through
    the port's one-buffer sweep, against the reference's stable argsort
    and its ``coverage_multi`` on the numpy and Pallas tiers."""
    rng = np.random.default_rng(13 + n)
    check_coverage(*coverage_bounds(rng, n), ("numpy", "pallas"))


@pytest.mark.parametrize("n", (1, 2, 9, 128, 515))
def test_coverage_delta_chain_matches_numpy_and_pallas(n):
    """The delta form's plain version (the chain to the reference's
    ``coverage_multi(delta)``) on random +1/-1 deltas."""
    rng = np.random.default_rng(13 + n)
    delta = rng.choice(np.array([1, -1], np.int64), n)
    got = ps._coverage_multi_delta_plain(torch.from_numpy(
        delta.astype(np.int32)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.cumsum(delta) >= 2)
    np.testing.assert_array_equal(
        got.numpy(), ref_ps.coverage_multi(delta, backend="pallas"))


@pytest.mark.parametrize("case", ["no_windows", "one_window", "all_equal",
                                  "start_equals_end", "duplicates",
                                  "past_int32_max", "many"])
def test_coverage_edges_match_reference(case):
    """n < 2; every bound the same page; windows whose start is another
    window's end and empty windows; duplicate starts and ends; page ids
    past INT32_MAX (int64 end to end); n = 5000."""
    rng = np.random.default_rng(len(case))
    if case == "no_windows":
        starts = ends = np.zeros(0, np.int64)
    elif case == "one_window":
        starts, ends = np.array([5], np.int64), np.array([9], np.int64)
    elif case == "all_equal":
        starts = ends = np.full(7, 40, np.int64)
    elif case == "start_equals_end":
        starts = np.array([0, 10, 10, 20, 30], np.int64)
        ends = np.array([10, 10, 20, 30, 30], np.int64)
    elif case == "duplicates":
        starts, ends = coverage_bounds(rng, 64, span=6, length=3)
    elif case == "past_int32_max":
        starts, ends = coverage_bounds(rng, 40, length=50,
                                       base=(1 << 33) + 17)
    else:
        starts, ends = coverage_bounds(rng, 5000, span=20000, length=300)
    backends = ("numpy",) + (("pallas",) if starts.size >= 2 else ())
    check_coverage(starts, ends, backends)


def _placement_model(starts, ends):
    """The kernel's placement in Python: start i at i + #(ends < v) with
    cover (i + 1) - #(ends < v); end j at j + #(starts <= u) with cover
    #(starts <= u) - (j + 1); each bound by itself, no scan."""
    n = starts.size
    pts = np.zeros(2 * n, np.int64)
    multi = np.zeros(2 * n, bool)
    for i, v in enumerate(starts):
        e = int(np.searchsorted(ends, v, "left"))
        pts[i + e], multi[i + e] = v, i + 1 - e >= 2
    for j, u in enumerate(ends):
        s = int(np.searchsorted(starts, u, "right"))
        pts[j + s], multi[j + s] = u, s - (j + 1) >= 2
    return pts, multi


@pytest.mark.parametrize("seed", range(4))
def test_coverage_placement_model_matches_stable_argsort(seed):
    """The kernel's placement (one binary search a bound) equals the
    stable argsort of the concatenated bounds and the running cover, and
    fills every position once, on random bounds tied within and across
    starts and ends."""
    rng = np.random.default_rng(seed)
    for n in (1, 2, 3, 17, 200):
        starts, ends = coverage_bounds(rng, n, span=max(n // 2, 1),
                                       length=4)
        pts, multi = _placement_model(starts, ends)
        want_pts, want_multi = coverage_want(starts, ends)
        np.testing.assert_array_equal(pts, want_pts)
        np.testing.assert_array_equal(multi, want_multi)
        slots = [i + int(np.searchsorted(ends, v, "left"))
                 for i, v in enumerate(starts)]
        slots += [j + int(np.searchsorted(starts, u, "right"))
                  for j, u in enumerate(ends)]
        assert sorted(slots) == list(range(2 * n))


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
    ps.pack_rows(plane)
    ps.popcount_rows(plane)
    ps.coverage_multi(torch.tensor([[1, 2], [3, 4]], dtype=torch.int64))
    ps.phase_step([plane], [torch.zeros((3, 4), dtype=torch.int32)])
    assert ps.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: ps.pack_rows(torch.ones((2, 3), dtype=torch.int32)),
    lambda: ps.popcount_rows(torch.ones(3, dtype=torch.int32)),
    lambda: ps.popcount_rows(torch.ones((2, 3), dtype=torch.int32)),
    lambda: ps.popcount_rows(torch.ones((2, 6), dtype=torch.bool)[:, ::2]),
    lambda: ps.coverage_multi(torch.ones(3, dtype=torch.int64)),
    lambda: ps.coverage_multi(torch.ones((2, 3), dtype=torch.int32)),
    lambda: ps.coverage_multi(torch.ones((3, 3), dtype=torch.int64)),
    lambda: ps.coverage_multi(torch.ones((2, 6), dtype=torch.int64)[:, ::2]),
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
