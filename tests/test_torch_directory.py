"""Directory-level parity of ``repro_torch.core.directory`` against the
reference ``repro.core.directory`` on the same seeded inputs: window grow
and shift, ``overlap_rows``/``gather_valid``/``clear_valid_cells``,
``count_range``, ``shared_intervals`` and ``dirty_counts`` on every tier
(page ids past INT32_MAX too, the bounds cache, no packing on the kernel
tiers), ``evict_rows``' dirty-victim counts, the span planes,
``IntervalLog.pending`` and the state round trip.
Tolerance: exact (every result is integer or boolean)."""
import numpy as np
import pytest
import torch

from repro.core import directory as ref_dir
from repro_torch.core import directory as pt_dir
from repro_torch.kernels import protocol_sweep as ps

# the port's tier and the reference tier it twins
TIERS = (("plain", "numpy"), ("kernels", "pallas"), ("fused", "pallas-jit"))


def _pair(W, page_hi, seed, *, wprot=False, tier=("plain", "numpy"),
          n_ops=12, touch=False, offset=0):
    """A reference and a port directory driven through the same seeded
    window growth (left and right extensions, fresh rows) and the same
    valid/dirty/wprot cell writes, over pages [offset, offset +
    page_hi)."""
    rng = np.random.default_rng(seed)
    ref = ref_dir.RegionDirectory(W, 0, offset, offset + page_hi,
                                  track_wprot=wprot, track_touch=touch,
                                  backend=tier[1])
    pt = pt_dir.RegionDirectory(W, 0, offset, offset + page_hi,
                                track_wprot=wprot, track_touch=touch,
                                backend=tier[0], device="cpu")
    pt.stats = {"fused_dispatches": 0}
    for _ in range(n_ops):
        w = int(rng.integers(0, W))
        lo = offset + int(rng.integers(0, page_hi - 1))
        hi = int(rng.integers(lo + 1, min(lo + 40, offset + page_hi) + 1))
        ref.ensure(w, lo, hi)
        pt.ensure(w, lo, hi)
        s = ref.sl(w, lo, hi)
        assert s == pt.sl(w, lo, hi)
        for name in ("valid", "dirty") + (("wprot",) if wprot else ()):
            cells = rng.random(hi - lo) < 0.5
            getattr(ref, name)[w, s] = cells
            getattr(pt, name)[w, s] = torch.from_numpy(cells)
    return ref, pt


def _assert_same(ref, pt):
    assert pt.cap == ref.cap
    for name in ("base", "length", "shift", "dirty_lo", "dirty_hi"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(ref, name),
                                      err_msg=name)
    for name in ("valid", "dirty", "wprot"):
        r = getattr(ref, name)
        if r is not None:
            np.testing.assert_array_equal(getattr(pt, name).numpy(), r,
                                          err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_window_grow_and_shift_match(seed):
    ref, pt = _pair(5, 300, seed, wprot=True, n_ops=20)
    _assert_same(ref, pt)


def test_ensure_rows_matches():
    ref, pt = _pair(6, 400, 9)
    rng = np.random.default_rng(10)
    rows = np.arange(6)
    lo = rng.integers(0, 300, 6)
    hi = lo + rng.integers(1, 60, 6)
    ref.ensure_rows(lo, hi, rows)
    pt.ensure_rows(lo, hi, rows)
    _assert_same(ref, pt)
    cols_r, mask_r = ref.range_cols(lo, hi, rows)
    cols_p, mask_p = pt.range_cols(lo, hi, rows)
    np.testing.assert_array_equal(cols_p, cols_r)
    np.testing.assert_array_equal(mask_p, mask_r)


@pytest.mark.parametrize("seed", range(3))
def test_overlap_gather_clear_match(seed):
    ref, pt = _pair(7, 250, 20 + seed)
    rng = np.random.default_rng(30 + seed)
    for _ in range(5):
        lo = int(rng.integers(0, 240))
        hi = int(rng.integers(lo + 1, 251))
        ex = int(rng.integers(0, 7))
        np.testing.assert_array_equal(pt.overlap_rows(lo, hi, exclude=ex),
                                      ref.overlap_rows(lo, hi, exclude=ex))
    rows = ref.overlap_rows(0, 250)
    pages = np.sort(rng.choice(250, 30, replace=False)).astype(np.int64)
    sub_r, cols_r = ref.gather_valid(rows, pages)
    sub_p, cols_p = pt.gather_valid(rows, pages)
    np.testing.assert_array_equal(sub_p, sub_r)
    np.testing.assert_array_equal(cols_p, cols_r)
    hit = sub_r & (rng.random(sub_r.shape) < 0.5)
    np.testing.assert_array_equal(pt.clear_valid_cells(rows, cols_p, hit),
                                  ref.clear_valid_cells(rows, cols_r, hit))
    _assert_same(ref, pt)


def test_count_range_matches():
    ref, pt = _pair(6, 500, 41, n_ops=18)
    rng = np.random.default_rng(42)
    lo = rng.integers(0, 450, 6)
    hi = lo + rng.integers(1, 50, 6)
    np.testing.assert_array_equal(pt.count_range(pt.valid, lo, hi),
                                  ref.count_range(ref.valid, lo, hi))
    rows = np.array([1, 3, 4])
    np.testing.assert_array_equal(
        pt.count_range(pt.dirty, lo[rows], hi[rows], rows=rows),
        ref.count_range(ref.dirty, lo[rows], hi[rows], rows=rows))


@pytest.mark.parametrize("tier", TIERS, ids=[t[0] for t in TIERS])
def test_shared_intervals_and_dirty_counts_per_tier(tier):
    for seed in range(3):
        ref, pt = _pair(8, 600, 50 + seed, tier=tier, n_ops=16)
        s_r, e_r = ref.shared_intervals()
        s_p, e_p = pt.shared_intervals()
        np.testing.assert_array_equal(s_p, s_r)
        np.testing.assert_array_equal(e_p, e_r)
        np.testing.assert_array_equal(pt.dirty_counts(), ref.dirty_counts())
        for w in range(8):
            np.testing.assert_array_equal(pt.row_dirty_cols(w),
                                          ref.row_dirty_cols(w))
        b_r, sb_r, se_r = ref.jit_geometry()
        b_p, sb_p, se_p = pt.jit_geometry()
        for a, b in ((b_p, b_r), (sb_p, sb_r), (se_p, se_r)):
            np.testing.assert_array_equal(a, b)
    # the fused tier notes its kernel calls as fused dispatches
    assert (pt.stats["fused_dispatches"] > 0) == (tier[0] == "fused")


@pytest.mark.parametrize("tier", TIERS, ids=[t[0] for t in TIERS])
def test_shared_intervals_past_int32_max_per_tier(tier):
    """Windows of pages past INT32_MAX: the sweep's int64 bounds keep
    them exact on every tier, as the reference's int64 sweep does."""
    for seed in range(2):
        ref, pt = _pair(8, 500, 150 + seed, tier=tier, n_ops=16,
                        offset=(1 << 33) + 11)
        s_r, e_r = ref.shared_intervals()
        s_p, e_p = pt.shared_intervals()
        assert s_r.size and s_r.min() > np.iinfo(np.int32).max
        np.testing.assert_array_equal(s_p, s_r)
        np.testing.assert_array_equal(e_p, e_r)
        np.testing.assert_array_equal(pt.dirty_counts(), ref.dirty_counts())


def test_coverage_bounds_cached_until_window_change():
    """The sweep's (2, n) int64 bounds tensor is built once and reused by
    every flush until a window changes: a call inside the windows keeps
    it, a growth drops it and the next sweep uploads the new bounds."""
    ref, pt = _pair(6, 300, 97, tier=("kernels", "pallas"), n_ops=14)
    ref.shared_intervals()
    t = pt.coverage_bounds()
    assert t.dtype == torch.int64 and tuple(t.shape) == (
        2, int((pt.base >= 0).sum()))
    np.testing.assert_array_equal(t.numpy(), np.stack(
        [ref._sorted_bases, ref._sorted_ends]))
    for _ in range(2):
        pt.shared_intervals()
        pt.dirty_counts()
        pt.jit_geometry_tensor()
    assert pt.coverage_bounds() is t
    w = int(np.nonzero(pt.base >= 0)[0][0])
    b, n = int(pt.base[w]), int(pt.length[w])
    pt.ensure(w, b, b + n)
    assert pt.coverage_bounds() is t
    for d in (ref, pt):
        d.ensure(w, b + n, b + n + 25)
    t2 = pt.coverage_bounds()
    assert t2 is not t
    for got, want in zip(pt.shared_intervals(), ref.shared_intervals()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t2.numpy(), np.stack(
        [ref._sorted_bases, ref._sorted_ends]))


@pytest.mark.parametrize("tier", TIERS[1:], ids=[t[0] for t in TIERS[1:]])
def test_kernel_tiers_pack_nothing(tier):
    """``dirty_counts``, ``shared_intervals`` and ``evict_rows`` on the
    kernel tiers call no ``pack_rows``: the kernels read the bool planes
    and the cached bounds themselves."""
    ref, pt = _pair(8, 600, 99, tier=tier, n_ops=16, touch=True)
    calls = dict(ps.CALLS)
    np.testing.assert_array_equal(pt.dirty_counts(), ref.dirty_counts())
    for got, want in zip(pt.shared_intervals(), ref.shared_intervals()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pt.evict_rows(np.arange(8), 0, pt.cap, None, set_wprot=False),
        ref.evict_rows(np.arange(8), 0, ref.cap, None, set_wprot=False))
    assert ps.CALLS["pack_rows"] == calls["pack_rows"]
    assert ps.CALLS["popcount_rows"] == calls["popcount_rows"] + 2
    assert ps.CALLS["coverage_multi"] == calls["coverage_multi"] + 1


@pytest.mark.parametrize("tier", TIERS, ids=[t[0] for t in TIERS])
@pytest.mark.parametrize("rows", [(2, 3, 4, 5), (0, 3, 7), (6,)],
                         ids=["run", "scattered", "one"])
def test_evict_rows_counts_match(tier, rows):
    """``evict_rows``' dirty-victim counts and plane updates against the
    reference's: a run of rows (the kernel reads a column window of the
    dirty plane in place), scattered rows (a gathered copy) and one row;
    the whole span, then a take mask over another span."""
    ref, pt = _pair(8, 600, 98, wprot=True, tier=tier, n_ops=24,
                    touch=True)
    rows = np.asarray(rows)
    rng = np.random.default_rng(len(rows))
    for start, length, masked in ((3, 29, False), (17, 41, True)):
        length = min(length, ref.cap - start)
        take = rng.random((rows.size, length)) < 0.5 if masked else None
        got = pt.evict_rows(rows, start, length,
                            None if take is None else torch.from_numpy(take),
                            set_wprot=True)
        want = ref.evict_rows(rows, start, length, take, set_wprot=True)
        np.testing.assert_array_equal(got, want)
        _assert_same(ref, pt)


def test_dirty_bounds_match():
    ref, pt = _pair(4, 100, 60)
    for d in (ref, pt):
        d.note_dirty(np.array([0, 2]), np.array([5, 9]), np.array([7, 30]))
        d.note_dirty(1, 3, 4)
        d.clear_dirty_bounds(2)
    _assert_same(ref, pt)
    for d in (ref, pt):
        d.clear_dirty_bounds()
    _assert_same(ref, pt)


def test_span_planes_match():
    """Span notes (scalar and per-page intervals), window growth with
    open spans, and harvests, on both packages."""
    ref, pt = _pair(3, 200, 70)
    rng = np.random.default_rng(71)
    for step in range(12):
        w = int(rng.integers(0, 3))
        lo = int(rng.integers(0, 190))
        hi = int(rng.integers(lo + 1, min(lo + 6, 200) + 1))
        for d in (ref, pt):
            d.ensure(w, lo, hi)
            d.ensure_span()
        if hi - lo == 1:
            wl, wh = int(rng.integers(0, 16)), int(rng.integers(16, 33))
        else:
            wl = rng.integers(0, 16, hi - lo)
            wh = rng.integers(16, 33, hi - lo)
        ref.span_note(w, lo, hi, wl, wh)
        pt.span_note(w, lo, hi, wl, wh)
        if step % 4 == 3:
            for v in range(3):
                if ref.base[v] < 0:
                    continue
                got = pt.span_harvest(v, 0, int(pt.base[v] + pt.length[v]))
                want = ref.span_harvest(v, 0,
                                        int(ref.base[v] + ref.length[v]))
                for g, x in zip(got, want):
                    np.testing.assert_array_equal(g, x)
    np.testing.assert_array_equal(pt.span_lo.numpy(), ref.span_lo)
    np.testing.assert_array_equal(pt.span_hi.numpy(), ref.span_hi)


def test_state_roundtrip_from_reference():
    ref, _ = _pair(5, 300, 80, wprot=True, n_ops=15)
    ref.ensure_span()
    arrays, meta = ref.state_arrays()
    pt = pt_dir.RegionDirectory.from_state(arrays, meta, backend="fused",
                                           device="cpu")
    _assert_same(ref, pt)
    back, back_meta = pt.state_arrays()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert back_meta["cap"] == meta["cap"]


def test_interval_log_pending_matches():
    rng = np.random.default_rng(90)
    ref, pt = ref_dir.IntervalLog(), pt_dir.IntervalLog()
    for _ in range(15):
        k = int(rng.integers(0, 6))
        pages = np.sort(rng.choice(40, k, replace=False)).astype(np.int64)
        los = rng.integers(0, 20, k)
        his = los + rng.integers(1, 20, k)
        ref.append_version(pages, los, his)
        pt.append_version(pages, los, his)
    for a in range(0, 15, 3):
        for b in range(a, 16, 4):
            for got, want in zip(pt.pending(a, b), ref.pending(a, b)):
                np.testing.assert_array_equal(got, want)
    moved = pt_dir.IntervalLog.from_state(ref.state_arrays())
    for got, want in zip(moved.pending(0, 15), ref.pending(0, 15)):
        np.testing.assert_array_equal(got, want)
