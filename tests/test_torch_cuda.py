"""The port's CUDA kernels and CUDA runtime against their plain versions,
on the card.  Every test here needs a CUDA device and skips without one
(marker ``gpu``).  Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerance: exact (integer kernels; clocks bit-equal, since charging runs
on the host in the same order whatever the device).  The model path's
float kernels use tests/test_kernels.py's tolerances in float32
(flash_attention 2e-5, ssd_chunk 1e-4); flash_attention in bfloat16 is
held to rtol 8e-3 / atol 2e-3 (both sides sum in float32 from the same
inputs, the kernel with p kept to 16 bits, and round once to bfloat16,
so they differ by at most one bfloat16 ulp, 2^-7 of the value, plus
float32 reordering), and the reduced
models on the card match the CPU to 1e-4 (float32 sums in another
order), with TF32 off."""
import dataclasses

import numpy as np
import pytest
import torch

import trace_fuzz
from repro_torch.core import directory as pt_dir
from repro_torch.core import make_runtime
from repro_torch.dsm import apps
from repro_torch.kernels import protocol_sweep as ps

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sorted_bounds(rng, n, span=0, length=20, base=0):
    """n windows' sorted starts and sorted ends, int64, as a (2, n)
    array: starts from ``span`` values (4n when 0: ties), lengths from
    [0, ``length``) (empty windows), offset by ``base``."""
    starts = base + rng.integers(0, span or max(4 * n, 1), n)
    ends = starts + rng.integers(0, length, n)
    return np.stack([np.sort(starts), np.sort(ends)]).astype(np.int64)


def test_kernels_match_plain_versions(dev):
    rng = np.random.default_rng(5)
    for W, C in ((1, 1), (3, 31), (37, 1000), (256, 16384), (256, 16385)):
        plane = torch.as_tensor(rng.random((W, C)) < 0.4, device=dev)
        bits = ps.pack_rows(plane)
        assert torch.equal(bits, ps._pack_rows_plain(plane))
        counts = ps.popcount_rows(plane)
        assert torch.equal(counts, ps._popcount_rows_bool_plain(plane))
        assert torch.equal(counts, ps._popcount_rows_plain(bits))
    for n in (0, 1, 9, 256, 257, 5000):
        bounds = torch.as_tensor(sorted_bounds(rng, n), device=dev)
        assert torch.equal(ps.coverage_multi(bounds),
                           ps._coverage_multi_plain(bounds))
    i32max = np.iinfo(np.int32).max
    R, W, C = 3, 9, 300
    planes = torch.as_tensor(rng.random((R, W, C)) < 0.5, device=dev)
    planes[:, 7:] = False
    base = np.full((R, W), -1, np.int32)
    base[:, :7] = np.arange(7) * 250
    sbs = np.full((R, W), i32max, np.int32)
    ses = np.full((R, W), i32max, np.int32)
    sbs[:, :7] = base[:, :7]
    ses[:, :7] = base[:, :7] + C
    args = ([p.contiguous() for p in planes],
            [torch.as_tensor(np.stack([base[r], sbs[r], ses[r]]),
                             device=dev) for r in range(R)],
            torch.as_tensor(rng.random((R, W)) < 0.8, device=dev))
    got = ps.read_phase_step(ps.phase_step(*args), R, W)
    want = ps.read_phase_step(ps._phase_step_plain(*args), R, W)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_phase_step_at_its_width_limit(dev):
    """At W = MAX_PHASE_STEP_W the staged bounds take the kernel past the
    48 KiB default shared memory (it opts in to more) and still launch;
    one row more is refused by the wrapper before launch."""
    rng = np.random.default_rng(6)
    W, C = ps.MAX_PHASE_STEP_W, 64
    base = np.arange(W, dtype=np.int32) * 40
    bounds = np.sort(base)
    args = ([torch.as_tensor(rng.random((W, C)) < 0.5, device=dev)],
            [torch.as_tensor(np.stack([base, bounds, bounds + 64]),
                             device=dev)],
            torch.as_tensor(rng.random((1, W)) < 0.8, device=dev))
    got = ps.read_phase_step(ps.phase_step(*args), 1, W)
    want = ps.read_phase_step(ps._phase_step_plain(*args), 1, W)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert want[1].size > 0
    wide = ([torch.zeros((W + 1, C), dtype=torch.bool, device=dev)],
            [torch.zeros((3, W + 1), dtype=torch.int32, device=dev)])
    with pytest.raises(ValueError, match="limits"):
        ps.phase_step(*wide)


@pytest.mark.parametrize("R,W,caps,dead,mask,step", [
    (3, 256, (16384,) * 3, False, False, None),     # fig3_weak's flush
    (3, 7, (150, 161, 99), True, True, None),
    (1, 1, (40,), False, False, None),
    (2, 64, (1000, 1003), True, True, 7),
    (3, 256, (517, 16383, 2049), True, False, None),  # rows off 16 bytes
    (3, 256, (16384, 16385, 4000), False, True, 301),
    (ps.MAX_PHASE_STEP_REGIONS + 1, 16, None, True, True, 3),  # 2 launches
], ids=lambda v: str(v))
def test_phase_step_matches_plain_version(dev, R, W, caps, dead, mask, step):
    """The flush kernel from the regions' bool planes against its plain
    version, read back as the engine reads it (counts, and the candidate
    entries sorted by key), at the main shape and the edges: ragged and
    unaligned caps that differ between regions, dead rows, W = 1, a
    sparse row mask or none, stacked windows that put several coverage
    breakpoints inside a word, more candidate words than the first copy
    takes, and one region more than a launch takes."""
    rng = np.random.default_rng(R * 1000 + W)
    if caps is None:
        caps = tuple(int(c) for c in rng.integers(1, 700, R))
    inp = ps.phase_step_inputs(rng, R, W, caps, dev, dead, mask, step)
    before = ps.LAUNCHES["phase_step"]
    got = ps.read_phase_step(ps.phase_step(*inp), R, W)
    assert ps.LAUNCHES["phase_step"] - before == -(
        -R // ps.MAX_PHASE_STEP_REGIONS)
    want = ps.read_phase_step(ps._phase_step_plain(*inp), R, W)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    again = ps.read_phase_step(ps.phase_step(*inp), R, W)
    for a, b in zip(again, want):   # the counters were left at zero
        np.testing.assert_array_equal(a, b)


def test_phase_step_stale_counters_write_nothing_past_out(dev):
    """Counters left stale on the card (a refused launch) put every slot
    past the flush's room: the kernel writes no entry there, the read
    raises, and the last block's reset leaves the next flush right."""
    rng = np.random.default_rng(11)
    inp = ps.phase_step_inputs(rng, 2, 64, (1000, 1003), dev, True, True, 7)
    want = ps.read_phase_step(ps._phase_step_plain(*inp), 2, 64)
    assert want[1].size > 0
    ps.phase_step_ws(torch.cuda.current_device())[0] = 1 << 30
    out = ps.phase_step(*inp)
    with pytest.raises(RuntimeError, match="stale"):
        ps.read_phase_step(out, 2, 64)
    torch.cuda.synchronize()   # a write 16 GB past out would fault here
    got = ps.read_phase_step(ps.phase_step(*inp), 2, 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("W,C", [(256, 16384), (256, 16385), (5, 16),
                                 (9, 33), (1, 1), (3, 48)])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_pack_rows_aligned_and_unaligned(dev, W, C, offset):
    """pack_rows on planes whose rows start on and off 16-byte boundaries
    (a view ``offset`` bytes into a buffer), against its plain version,
    and into a wider buffer."""
    rng = np.random.default_rng(W + C + offset)
    buf = torch.zeros(W * C + 16, dtype=torch.bool, device=dev)
    plane = buf[offset:offset + W * C].view(W, C)
    plane.copy_(torch.as_tensor(rng.random((W, C)) < 0.5, device=dev))
    want = ps._pack_rows_plain(plane)
    assert torch.equal(ps.pack_rows(plane), want)
    wide = torch.full((W, want.shape[1] + 2), -1, dtype=torch.int32,
                      device=dev)
    ps.pack_rows(plane, out=wide)
    assert torch.equal(wide[:, :-2], want)
    assert not wide[:, -2:].any()


@pytest.mark.parametrize("R,C", [(256, 16384), (3, 16385), (5, 16),
                                 (9, 33), (1, 1), (2, 1000), (4, 1031),
                                 (1, 0)])
@pytest.mark.parametrize("offset", [0, 1, 4, 15])
def test_popcount_rows_unaligned_and_strided_rows(dev, R, C, offset):
    """popcount_rows on rows that start on and off 16-byte boundaries (a
    view ``offset`` bytes into a buffer that the plane ends, so a ragged
    tail ends at the allocation's end), a column window of a wider plane,
    every other row of one, and mask bytes of 2 and 0xff: read in place,
    against the plain version on contiguous copies."""
    rng = np.random.default_rng(R + C + offset)
    buf = torch.zeros(R * C + offset, dtype=torch.uint8, device=dev)
    plane = buf[offset:].view(R, C)
    plane.copy_(torch.as_tensor(
        rng.choice(np.array([0, 1, 2, 255], np.uint8), (R, C)), device=dev))
    wide = torch.as_tensor(rng.random((2 * R, C + 2 * offset + 3)) < 0.5,
                           device=dev)
    for rows in (plane.view(torch.bool), wide[:R, offset:offset + C],
                 wide[::2, offset + 3:offset + 3 + C]):
        want = ps._popcount_rows_bool_plain(rows.contiguous())
        assert torch.equal(ps.popcount_rows(rows), want)
        assert torch.equal(want.cpu(), ps._popcount_rows_bool_plain(
            rows.cpu()))


@pytest.mark.parametrize("case", ["one", "all_equal", "start_equals_end",
                                  "duplicates", "past_int32_max", "many"])
def test_coverage_multi_edges(dev, case):
    """coverage_multi on the edges of the sweep: n = 1, every bound the
    same page, windows ending where others start and empty windows,
    duplicate starts and ends, page ids past INT32_MAX and n = 5000,
    against the plain version (a stable sort and a cumsum)."""
    rng = np.random.default_rng(len(case))
    bounds = {
        "one": lambda: np.array([[5], [9]], np.int64),
        "all_equal": lambda: np.full((2, 7), 40, np.int64),
        "start_equals_end": lambda: np.array([[0, 10, 10, 20, 30],
                                              [10, 10, 20, 30, 30]],
                                             np.int64),
        "duplicates": lambda: sorted_bounds(rng, 64, span=6, length=3),
        "past_int32_max": lambda: sorted_bounds(rng, 40, length=50,
                                                base=(1 << 33) + 17),
        "many": lambda: sorted_bounds(rng, 5000, span=20000, length=300),
    }[case]()
    t = torch.as_tensor(bounds, device=dev)
    want = ps._coverage_multi_plain(t)
    assert torch.equal(ps.coverage_multi(t), want)
    assert torch.equal(want.cpu(), ps._coverage_multi_plain(t.cpu()))


def test_kernels_tier_flush_and_eviction_launch_no_pack_rows(dev,
                                                             monkeypatch):
    """On 'kernels' the unfused barrier flush (dirty_counts,
    shared_intervals) and batched eviction (evict_rows) launch
    popcount_rows and coverage_multi and no pack_rows, with traffic and
    clocks equal to the same runs on the CPU."""
    evicts = []
    orig = pt_dir.RegionDirectory.evict_rows

    def counted(self, *a, **kw):
        evicts.append(self.device.type)
        return orig(self, *a, **kw)
    monkeypatch.setattr(pt_dir.RegionDirectory, "evict_rows", counted)
    before = dict(ps.LAUNCHES)
    runs = {}
    for device in ("cpu", "cuda"):
        flush = make_runtime(16, protocol="page", fetch_batch=16,
                             backend="kernels", device=device)
        apps.jacobi(flush, 128, 3, mode="lock")
        spill = make_runtime(16, protocol="fine", fetch_batch=16,
                             cache_pages=40, backend="kernels",
                             device=device)
        apps.stream_triad(spill, 16 * 1024 * 64, 2, driver="batched")
        runs[device] = (flush, spill)
    for a, b in zip(runs["cpu"], runs["cuda"]):
        assert dataclasses.asdict(a.traffic) == dataclasses.asdict(b.traffic)
        np.testing.assert_array_equal(a.clock, b.clock)
    launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
    assert "cuda" in evicts
    assert launched["pack_rows"] == 0, launched
    assert launched["popcount_rows"] > 0 and launched["coverage_multi"] > 0


@pytest.mark.parametrize("backend", ("kernels", "fused"))
def test_cuda_runtime_matches_cpu(dev, backend):
    runs = {}
    for device in ("cpu", "cuda"):
        rt = make_runtime(16, protocol="page", fetch_batch=16,
                          backend=backend, device=device)
        apps.jacobi(rt, 128, 3, mode="lock")
        runs[device] = rt
    assert dataclasses.asdict(runs["cpu"].traffic) == dataclasses.asdict(
        runs["cuda"].traffic)
    np.testing.assert_array_equal(runs["cpu"].clock, runs["cuda"].clock)


@pytest.mark.parametrize("cache_pages", (None, 64, 3))
@pytest.mark.parametrize("backend", ("kernels", "fused"))
def test_cuda_lock_contention_matches_cpu(dev, backend, cache_pages):
    """A small lock_contention point (W=16, span_all's grant groups; a
    roomy cache adds the touch bookkeeping, a tight one serializes the
    spans) on the card against the CPU, bit-equal; the hoisted flush
    launches phase_step with its row mask on 'fused', popcount_rows and
    coverage_multi on 'kernels'."""
    runs = {}
    for device in ("cpu", "cuda"):
        rt = make_runtime(16, protocol="page", fetch_batch=16,
                          page_words=64, cache_pages=cache_pages,
                          backend=backend, device=device)
        ps.reset_launches()
        apps.lock_contention(rt, 1 << 12, 2, sweeps=2)
        runs[device] = rt
    cpu, card = runs["cpu"], runs["cuda"]
    assert dataclasses.asdict(cpu.traffic) == dataclasses.asdict(
        card.traffic)
    np.testing.assert_array_equal(cpu.clock, card.clock)
    assert cpu.stats == card.stats
    if card.stats["span_serial_calls"]:
        return
    assert card.stats["span_workers_vec"] == 2 * 2 * 2 * 16
    if backend == "fused":
        assert ps.ROWMASK_LAUNCHES["phase_step"] > 0
    else:
        assert ps.LAUNCHES["popcount_rows"] > 0
        assert ps.LAUNCHES["coverage_multi"] > 0


@pytest.mark.parametrize("driver", ("batched", "loop"))
@pytest.mark.parametrize("backend", ("kernels", "fused"))
def test_cuda_race_audit_matches_cpu(dev, backend, driver):
    """race_audit at W=64 with detection on (phase_all's batched checks,
    the grant-chain pass of span_all) on the card against the CPU: the
    race set, its counts, stats, traffic and clocks equal; the flush
    kernels launched on the card."""
    runs = {}
    for device in ("cpu", "cuda"):
        rt = make_runtime(64, protocol="fine", fetch_batch=16,
                          backend=backend, device=device, detect_races=True)
        ps.reset_launches()
        apps.race_audit(rt, 1 << 18, 2, driver=driver)
        runs[device] = rt
    cpu, card = runs["cpu"], runs["cuda"]
    assert card.races == cpu.races and card.races
    assert card.race_counts == cpu.race_counts
    assert card.stats == cpu.stats
    assert dataclasses.asdict(cpu.traffic) == dataclasses.asdict(
        card.traffic)
    np.testing.assert_array_equal(cpu.clock, card.clock)
    if backend == "fused":
        assert ps.LAUNCHES["phase_step"] > 0
    else:
        assert ps.LAUNCHES["popcount_rows"] > 0
        assert ps.LAUNCHES["coverage_multi"] > 0


def test_cuda_race_hits_many_matches_cpu(dev, monkeypatch):
    """The batched race check on card planes against the same check on
    CPU planes: seeded windows, notes and views, both planes, with the
    chunk size cut so that one check takes several round trips."""
    rng = np.random.default_rng(21)
    W, P = 24, 300
    dirs = {d: pt_dir.RegionDirectory(W, 0, 0, P, device=d)
            for d in ("cpu", "cuda")}
    for w in range(W):
        lo = int(rng.integers(0, P - 40))
        hi = lo + int(rng.integers(1, 40))
        for d in dirs.values():
            d.ensure(w, lo, hi)
    for _ in range(60):
        w = int(rng.integers(0, W))
        b = dirs["cpu"]
        lo = int(b.base[w] + rng.integers(0, b.length[w]))
        hi = int(rng.integers(lo + 1, b.base[w] + b.length[w] + 1))
        ep, wr = int(rng.integers(1, 9)), bool(rng.random() < 0.5)
        for d in dirs.values():
            d.race_note(w, lo, hi, ep, wr)
    n = 40
    p_lo = rng.integers(0, P - 20, n)
    p_hi = p_lo + rng.integers(1, 20, n)
    views = rng.integers(0, 8, (n, W))
    monkeypatch.setattr(pt_dir.RegionDirectory, "RACE_CELLS", 7)
    got = {}
    for name, d in dirs.items():
        got[name] = d.race_hits_many(p_lo, p_hi, views, (True, False))
    for (a, b) in zip(got["cpu"], got["cuda"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert sum(a[0].size for a in got["cpu"]) > 0


def _rank_cases(rng, plane):
    """Random and edge ranks of bool rows ``plane`` (host): 0, negative,
    each row's count and one past it, INT32_MAX."""
    R, C = plane.shape
    tot = plane.sum(axis=1)
    return [rng.integers(-3, C + 5, R), np.zeros(R), np.full(R, -4), tot,
            tot + 1, np.maximum(tot - 1, 1),
            np.full(R, np.iinfo(np.int32).max)]


def _rank_select_equal(live, k):
    """The three entries on ``live`` (a card tensor, maybe a view) with
    ranks ``k`` (a card tensor or an int) against their plain versions
    on a contiguous copy."""
    kp = k if isinstance(k, torch.Tensor) else torch.tensor(
        [k], dtype=torch.int64, device=live.device)
    want_t = ps._take_first_k_bool_plain(live.contiguous(), kp)
    want_c = ps._kth_set_index_bool_plain(live.contiguous(), kp)
    assert torch.equal(ps.take_first_k(live, k), want_t)
    assert torch.equal(ps.kth_set_index(live, k), want_c)
    got_t, got_c = ps.take_and_cut(live, k)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_c, want_c)


def test_rank_select_kernels_match_plain_versions(dev):
    """take_first_k, kth_set_index and take_and_cut on bool rows against
    their plain versions on the card: random and edge ranks (0, negative,
    the row's count and one past it, INT32_MAX), ragged last words, an
    empty row, all-set rows, R=1 / C=1, rows of one warp (C <= 1024) and
    of one block (the lru_take shape, and a row of several scan rounds);
    int32 and int64 ranks, and ranks by value for one row."""
    rng = np.random.default_rng(12)
    for R, C in ((1, 1), (1, 7), (1, 32), (3, 31), (5, 300), (4, 1024),
                 (3, 1025), (256, 32768), (2, 256 * 4 * 32 * 3 + 7)):
        plane = rng.random((R, C)) < rng.random((R, 1))
        plane[0] = True
        if R > 2:
            plane[-1] = False
        live = torch.as_tensor(plane, device=dev)
        for k in _rank_cases(rng, plane):
            kt = torch.as_tensor(np.asarray(k, np.int64), device=dev)
            for kk in (kt, kt.to(torch.int32)):
                _rank_select_equal(live, kk)
            if R == 1:
                _rank_select_equal(live, int(k[0]))


@pytest.mark.parametrize("R,C", [(256, 16384), (3, 16385), (5, 16),
                                 (9, 33), (1, 9), (2, 1000), (4, 1031)])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_rank_select_unaligned_and_strided_rows(dev, R, C, offset):
    """Rows that start on and off 16-byte boundaries (a view ``offset``
    bytes into a buffer that the plane ends, so a ragged last word ends
    at the allocation's end), a column window of a wider plane, and every
    other row of one: read in place, against the plain versions on
    contiguous copies."""
    rng = np.random.default_rng(R + C + offset)
    buf = torch.zeros(R * C + offset, dtype=torch.bool, device=dev)
    plane = buf[offset:].view(R, C)
    plane.copy_(torch.as_tensor(rng.random((R, C)) < 0.5, device=dev))
    wide = torch.as_tensor(rng.random((2 * R, C + 2 * offset + 3)) < 0.5,
                           device=dev)
    for live in (plane, wide[:R, offset:offset + C],
                 wide[::2, offset + 3:offset + 3 + C]):
        for k in _rank_cases(rng, live.cpu().numpy()):
            _rank_select_equal(live, torch.as_tensor(
                np.asarray(k, np.int64), device=dev))


@pytest.mark.parametrize("fused", [True, False])
def test_take_run_matches_plain_version(dev, fused):
    """The one-run form on runs as the replay hands them (a column window
    of one plane row, at several byte offsets, up to two warps' words):
    [cut, count, columns] read back in one copy, against the plain
    version."""
    rng = np.random.default_rng(7 + fused)
    plane = torch.as_tensor(rng.random((3, 2200)) < 0.6, device=dev)
    for w, a, b in ((0, 0, 7), (1, 1, 10), (2, 17, 26), (0, 3, 2200),
                    (1, 100, 1124), (2, 5, 6), (0, 64, 1089)):
        run = plane[w, a:b]
        nz = int(run.sum())
        for k in (1, 2, nz - 1, nz, nz + 1, 0, -1):
            got = ps.read_take_run(ps.take_run(run, k, fused))
            want = ps.read_take_run(ps._take_run_plain(run, k))
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("backend", ("kernels", "fused"))
def test_cuda_spill_runtime_matches_cpu(dev, backend, monkeypatch):
    """One gen_danger_program trace (mid-op refetch under a small cache)
    on the card and on the CPU: equal traffic and stats, bit-equal clocks
    after every event, the rank-select kernels launched, and no pack_rows
    launch from the rank-select calls (take_upto_row, lru_take)."""
    rank_packs = []
    for name in ("take_upto_row", "lru_take"):
        orig = getattr(pt_dir.RegionDirectory, name)

        def counted(self, *a, _orig=orig, **kw):
            n = ps.LAUNCHES["pack_rows"]
            out = _orig(self, *a, **kw)
            if self.device.type == "cuda":
                rank_packs.append(ps.LAUNCHES["pack_rows"] - n)
            return out
        monkeypatch.setattr(pt_dir.RegionDirectory, name, counted)
    p = trace_fuzz.danger_trace_params(5)
    prog = trace_fuzz.gen_danger_program(p["rng"], p["W"], p["n_words"],
                                         p["page_words"], p["cache_pages"])
    runs = {d: make_runtime(p["W"], protocol=p["proto"],
                            page_words=p["page_words"],
                            cache_pages=p["cache_pages"], backend=backend,
                            device=d) for d in ("cpu", "cuda")}
    gas = {d: [rt.alloc(p["n_words"]) for _ in range(2)]
           for d, rt in runs.items()}
    before = dict(ps.LAUNCHES)
    for ev in prog:
        for d, rt in runs.items():
            trace_fuzz.apply_event(rt, ev, gas[d], "batched")
        assert dataclasses.asdict(runs["cpu"].traffic) == dataclasses.asdict(
            runs["cuda"].traffic)
        np.testing.assert_array_equal(runs["cpu"].clock, runs["cuda"].clock)
    assert runs["cpu"].stats == runs["cuda"].stats
    assert runs["cuda"].stats["danger_vec_ops"] > 0
    launched = {k: ps.LAUNCHES[k] - before[k] for k in ps.LAUNCHES}
    rank = ("take_and_cut",) if backend == "fused" else ("take_first_k",
                                                          "kth_set_index")
    assert all(launched[k] > 0 for k in rank), launched
    # the rank-select path reads the bool runs itself: no pack_rows
    assert rank_packs and not any(rank_packs), rank_packs


def _bits_equal(a, b):
    a = a.view(torch.int32) if a.dtype == torch.float32 else a
    b = b.view(torch.int32) if b.dtype == torch.float32 else b
    return a.shape == b.shape and torch.equal(a, b)


def test_page_diff_kernels_match_plain_versions(dev):
    """diff_encode and diff_apply against their plain versions, bit for
    bit, at the reference path's shapes, a batched and a ragged shape,
    with the edge bit patterns (-0.0, NaN payloads, equal NaN bits,
    denormals) and mask bytes of -1 and 2; also on rows that start off
    the 16-byte alignment (the scalar path)."""
    import chip_smoke
    from repro_torch.kernels import page_diff as pd
    rng = np.random.default_rng(13)
    for n, w in ((1, 256), (1, 1024), (4096, 1024), (5, 1001), (3, 4)):
        curr, twin, mask = (torch.as_tensor(a, device=dev) for a in
                            chip_smoke.page_diff_inputs(np, rng, n, w))
        flat = torch.empty(2 * n * w + 1, device=dev)
        shifted = flat[1:n * w + 1].view(n, w)       # 4 bytes off alignment
        shifted.copy_(curr)
        for c in (curr, shifted):
            enc = pd.diff_encode(c, twin)
            assert all(_bits_equal(a, b) for a, b in
                       zip(enc, pd._diff_encode_plain(c, twin)))
            assert _bits_equal(pd.diff_apply(twin, enc[0], enc[1]), curr)
            assert _bits_equal(pd.diff_apply(twin, mask, c),
                               pd._diff_apply_plain(twin, mask, c))
    empty = pd.diff_encode(torch.zeros(0, 8, device=dev),
                           torch.zeros(0, 8, device=dev))
    assert empty[2].shape == (0,)


def test_diff_encode_bounds_match_plain_version(dev):
    """diff_encode(bounds=True) on the card against its plain version,
    bit for bit: pages with no changed word, one at word 0 or W - 1,
    -0.0 against +0.0, NaN payloads, or ~10% changed, n in {1, 7}, and
    on rows that start off the 16-byte alignment (the scalar path)."""
    import chip_smoke
    from repro_torch.kernels import page_diff as pd
    rng = np.random.default_rng(15)
    for case in chip_smoke.BOUNDS_CASES:
        for n in (1, 7):
            for w in (256, 1001, 4):
                curr, twin = (torch.as_tensor(a, device=dev) for a in
                              chip_smoke.page_diff_bounds_inputs(
                                  np, rng, case, n, w))
                flat = torch.empty(n * w + 1, device=dev)
                shifted = flat[1:].view(n, w)
                shifted.copy_(curr)
                want = pd._diff_encode_plain(curr, twin, True)
                for c in (curr, shifted):
                    got = pd.diff_encode(c, twin, bounds=True)
                    assert got[2].shape == (3, n)
                    assert all(_bits_equal(a, b) for a, b in zip(got, want))


def test_cuda_reference_matches_cpu(dev):
    """The per-page reference engine with page values on the card against
    the same runs on the CPU: a seeded DRF program (span writes of one
    lock, then every worker's read) and the dsm_jacobi program.  Traffic,
    clocks, reads and home bit-equal; the page_diff launches equal the
    CPU run's wrapper calls."""
    import chip_smoke
    from repro_torch.kernels import page_diff as pd
    rng = np.random.default_rng(21)
    ops = [(int(rng.integers(0, 3)), int(lo), int(lo + rng.integers(1, 9)),
            float(rng.uniform(-100, 100)))
           for lo in rng.integers(0, 120, 12)]
    for proto in ("fine", "page"):
        runs, reads, called = {}, {}, {}
        for d in ("cpu", "cuda"):
            rt = make_runtime(3, engine="reference", page_words=64,
                              protocol=proto, device=d)
            g = rt.alloc(128)
            before, calls = dict(pd.LAUNCHES), dict(pd.CALLS)
            for w, lo, hi in ((w, lo, hi) for w, lo, hi, _ in ops):
                with rt.span(w, 0):
                    rt.write(w, g, lo, hi, np.full(hi - lo, w + 0.5,
                                                   np.float32))
            rt.barrier()
            reads[d] = [rt.read(w, g, 0, 128).cpu() for w in range(3)]
            runs[d] = rt
            called[d] = {k: pd.CALLS[k] - calls[k] for k in pd.CALLS}
        launched = {k: pd.LAUNCHES[k] - before[k] for k in pd.LAUNCHES}
        assert launched == called["cpu"]
        assert dataclasses.asdict(runs["cpu"].traffic) == dataclasses.asdict(
            runs["cuda"].traffic)
        np.testing.assert_array_equal(runs["cpu"].clock, runs["cuda"].clock)
        assert all(_bits_equal(a, b) for a, b in zip(reads["cpu"],
                                                     reads["cuda"]))
        assert _bits_equal(runs["cpu"].home, runs["cuda"].home.cpu())
    jac = {}
    encodes = pd.LAUNCHES["diff_encode"]
    for d in ("cpu", "cuda"):
        rt = make_runtime(4, engine="reference", page_words=256, device=d)
        jac[d] = (rt, chip_smoke.dsm_jacobi(rt, 32, 40, "lock")[0])
    assert jac["cpu"][1].tobytes() == jac["cuda"][1].tobytes()
    np.testing.assert_array_equal(jac["cpu"][0].clock, jac["cuda"][0].clock)
    assert pd.LAUNCHES["diff_encode"] > encodes


@pytest.fixture
def f32_card(dev):
    """The card with float32 products in full float32 (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield dev
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def test_flash_attention_matches_plain_version(f32_card):
    """Every head dim, GQA/MQA/MHA, ragged S, window and softcap, causal
    or not, float32 and bfloat16, and strided (B, S, H, D) operands."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(31)
    for (B, Hq, Hkv, S, D) in ((1, 4, 4, 1, 16), (2, 4, 2, 40, 16),
                               (1, 8, 1, 100, 32), (2, 4, 4, 257, 64),
                               (1, 16, 8, 333, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = chip_smoke.flash_inputs(torch, np, rng, B, Hq, Hkv, S,
                                              D, dtype, f32_card)
            rtol, atol = ((8e-3, 2e-3) if dtype == torch.bfloat16
                          else (2e-5, 2e-5))
            for kw in ({}, {"causal": False}, {"window": 16, "softcap": 30.0},
                       {"scale": 0.1, "window": 3}):
                got = fa.flash_attention(q, k, v, **kw)
                want = fa.flash_attention_plain(q, k, v, **kw)
                assert got.dtype == dtype
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=rtol, atol=atol)
            strided = [t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v)]
            assert torch.equal(fa.flash_attention(*strided),
                               fa.flash_attention(q, k, v))


def test_flash_attention_unaligned_operands(f32_card):
    """Operands whose base is one element off the 16-byte alignment the
    kernel's cp.async copies need (K and V are then copied element by
    element, never refused): the same result as aligned copies, within
    the tolerances of the plain version."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(34)
    for (B, Hq, Hkv, S, D) in ((2, 4, 2, 40, 16), (1, 16, 8, 333, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = chip_smoke.flash_inputs(torch, np, rng, B, Hq, Hkv, S,
                                              D, dtype, f32_card)
            moved = []
            for t in (q, k, v):
                flat = torch.empty(t.numel() + 1, dtype=dtype,
                                   device=f32_card)
                moved.append(flat[1:].view(t.shape))
                moved[-1].copy_(t)
            rtol, atol = ((8e-3, 2e-3) if dtype == torch.bfloat16
                          else (2e-5, 2e-5))
            for kw in ({}, {"window": 16, "softcap": 30.0}):
                got = fa.flash_attention(*moved, **kw)
                torch.testing.assert_close(
                    got.float(), fa.flash_attention_plain(q, k, v,
                                                          **kw).float(),
                    rtol=rtol, atol=atol)
                assert torch.equal(got, fa.flash_attention(q, k, v, **kw))


def test_ssd_chunk_matches_plain_version(f32_card):
    """Every (P, N), grouped and per-cell B/C rows, ragged Q, float32 and
    bfloat16."""
    import chip_smoke
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(32)
    for (M, Q, P, N, rep) in ((4, 64, 32, 64, 1), (2, 128, 64, 128, 1),
                              (8, 32, 16, 32, 4), (6, 7, 16, 16, 3),
                              (160, 256, 64, 128, 80), (3, 300, 128, 16, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            args = chip_smoke.ssd_inputs(torch, np, rng, M, Q, P, N, rep,
                                         dtype, f32_card)
            for g, w in zip(sc.ssd_chunk(*args), sc.ssd_chunk_plain(*args)):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rep", [1, 2, 80])
@pytest.mark.parametrize("Q", [1, 100, 256])
def test_ssd_chunk_every_width_and_group(f32_card, rep, Q):
    """The split-TF32 tensor-core kernel at every (P, N) in {16, 64,
    128}^2, one B/C row per 1, 2 or 80 heads, ragged Q, float32 and
    bfloat16, within 1e-4 of the plain version; also from operands 4
    bytes off the 16-byte alignment its cp.async copies need."""
    import chip_smoke
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(33 + rep + Q)
    for P in (16, 64, 128):
        for N in (16, 64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                args = chip_smoke.ssd_inputs(torch, np, rng, 2 * rep, Q, P,
                                             N, rep, dtype, f32_card)
                for g, w in zip(sc.ssd_chunk(*args),
                                sc.ssd_chunk_plain(*args)):
                    torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    x = args[0]
    flat = torch.empty(x.numel() + 2, dtype=x.dtype, device=f32_card)
    shifted = flat[2:].view(x.shape)
    shifted.copy_(x)
    moved = [shifted] + list(args[1:])
    for g, w in zip(sc.ssd_chunk(*moved), sc.ssd_chunk(*args)):
        assert torch.equal(g, w)


def test_inplace_merges_match_plain_versions(dev):
    """diff_apply_ and diff_apply_rows_ on the card against their plain
    versions, bit for bit, with the edge bit patterns and mask bytes of
    -1 and 2, at the reference path's shapes, a batched and a ragged
    shape, on one page (W,) and on rows that start off the 16-byte
    alignment (the scalar path)."""
    import chip_smoke
    from repro_torch.kernels import page_diff as pd
    rng = np.random.default_rng(14)
    for n, w in ((1, 256), (1, 1024), (4096, 1024), (5, 1001), (3, 4)):
        curr, twin, mask = (torch.as_tensor(a, device=dev) for a in
                            chip_smoke.page_diff_inputs(np, rng, n, w))
        got, want = twin.clone(), twin.clone()
        assert pd.diff_apply_(got, mask, curr) is got
        pd._diff_apply_plain_(want, mask, curr)
        assert _bits_equal(got, want)
        assert _bits_equal(got, pd.diff_apply(twin, mask, curr))
        page, ref = twin[-1].clone(), twin[-1].clone()
        pd.diff_apply_(page, mask[-1], curr[-1])
        pd._diff_apply_plain_(ref, mask[-1], curr[-1])
        assert _bits_equal(page, ref)
        flat = torch.empty(n * w + 1, device=dev)
        shifted = flat[1:].view(n, w)
        shifted.copy_(twin)
        pd.diff_apply_(shifted, mask, curr)
        assert _bits_equal(shifted, want)
        n_home = 3 * n + 2
        home = torch.as_tensor(rng.standard_normal((n_home, w)),
                               dtype=torch.float32, device=dev)
        rows = torch.as_tensor(np.sort(rng.choice(n_home, n, replace=False)),
                               device=dev)
        got, want = home.clone(), home.clone()
        assert pd.diff_apply_rows_(got, rows, mask, curr) is got
        pd._diff_apply_rows_plain_(want, rows, mask, curr)
        assert _bits_equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b",
                                  "gemma2-27b", "granite-20b",
                                  "grok-1-314b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b",
                                  "musicgen-medium"])
def test_reduced_models_match_cpu(f32_card, arch):
    """A reduced model on the card against the same parameters on the
    CPU: greedy tokens equal, every step's logits (teacher-forced with the
    card's tokens) within 1e-4, and the card run through the kernels.
    Embeds configs take N(0, 1) prompt embeddings, M-RoPE configs
    (3, B, S) positions of text then an image grid
    (``chip_smoke.prompt_of``)."""
    import chip_smoke
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models.model import init_model_params
    from repro_torch.serve.decode import generate
    cfg = get_reduced(arch)
    cpu = init_model_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    card = {k: ([{n: t.cuda() for n, t in b.items()} for b in v]
                if k == "blocks" else v.cuda()) for k, v in cpu.items()}
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 45), dtype=np.int32)
    prompt = chip_smoke.prompt_of(np, cfg, toks, rng)
    before = (fa.LAUNCHES["flash_attention"], sc.LAUNCHES["ssd_chunk"])
    got = generate(cfg, card, prompt, max_new_tokens=6, device="cuda").cpu()
    launched = (fa.LAUNCHES["flash_attention"] - before[0],
                sc.LAUNCHES["ssd_chunk"] - before[1])
    want = generate(cfg, cpu, prompt, max_new_tokens=6, device="cpu")
    assert torch.equal(got, want)
    n = chip_smoke.layer_counts(cfg)
    assert launched == (n["flash_attention"], n["ssd_chunk"])
    forced = got.numpy()
    torch.testing.assert_close(
        chip_smoke.step_logits(torch, cfg, card, prompt, forced, "cuda"),
        chip_smoke.step_logits(torch, cfg, cpu, prompt, forced, "cpu"),
        rtol=1e-4, atol=1e-4)


def test_flash_attention_function_grads_on_card(f32_card):
    """The autograd Function on the card: the kernel's forward (launched,
    its value) and gradients equal to autograd of the plain version there,
    float32 within 1e-4 of the largest gradient; bfloat16 against the
    float32 gradients of the same values at the kernel's tolerances (the
    Function rounds them once); S = 1500 recomputes in two query
    blocks."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(35)
    for (B, Hq, Hkv, S, D) in ((2, 4, 2, 40, 16), (1, 8, 1, 100, 32),
                               (1, 4, 2, 1500, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.requires_grad_(True) for t in chip_smoke.flash_inputs(
                torch, np, rng, B, Hq, Hkv, S, D, dtype, f32_card))
            for kw in ({}, {"window": 16, "softcap": 30.0}):
                before = fa.LAUNCHES["flash_attention"]
                out = fa.flash_attention(q, k, v, **kw)
                assert fa.LAUNCHES["flash_attention"] == before + 1
                with torch.no_grad():
                    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
                g = torch.randn(out.shape, device=f32_card).to(dtype)
                got = torch.autograd.grad(out, (q, k, v), g)
                # bfloat16 against the float32 gradients of the same values
                up = [t.detach().float().requires_grad_(True)
                      for t in (q, k, v)]
                want = torch.autograd.grad(
                    fa.flash_attention_plain(*up, **kw), up, g.float())
                for a, b in zip(got, want):
                    assert a.dtype == dtype
                    if dtype == torch.float32:
                        torch.testing.assert_close(
                            a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
                    else:
                        torch.testing.assert_close(a.float(), b,
                                                   rtol=8e-3, atol=2e-3)


def test_ssd_chunk_function_grads_on_card(f32_card):
    """The SSD autograd Function on the card: the kernel's forward and
    the plain version's gradients, within 1e-4 of the largest gradient."""
    import chip_smoke
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(36)
    for (M, Q, P, N, rep) in ((4, 64, 32, 64, 1), (8, 32, 16, 32, 4),
                              (6, 7, 16, 16, 3)):
        args = [t.requires_grad_(True) for t in chip_smoke.ssd_inputs(
            torch, np, rng, M, Q, P, N, rep, torch.float32, f32_card)]
        before = sc.LAUNCHES["ssd_chunk"]
        y, st = sc.ssd_chunk(*args)
        assert sc.LAUNCHES["ssd_chunk"] == before + 1
        gy, gs = torch.randn_like(y), torch.randn_like(st)
        got = torch.autograd.grad((y, st), args, (gy, gs))
        want = torch.autograd.grad(sc.ssd_chunk_plain(*args), args, (gy, gs))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b",
                                  "gemma2-27b", "granite-20b", "llama3-405b",
                                  "grok-1-314b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b",
                                  "musicgen-medium"])
def test_reduced_train_step_matches_cpu(f32_card, arch):
    """One train step (AdamW, remat "full") of a reduced model on the card
    against the CPU on the same parameters (``chip_smoke.train_twin``:
    routes first, loss within 1e-4, grad norm 1e-4 relative, gradient
    leaves 1e-3 of their largest value, the card's AdamW on the CPU's
    gradients within 1e-6), through the kernels: each attention and SSD
    layer launched twice in the step (the forward and the remat's
    recompute), and twice again in the step's halves that the twin reruns
    on the card."""
    import chip_smoke
    from repro_torch.configs import get_reduced
    from repro_torch.train.train_step import TrainHParams, init_train_state
    cfg = get_reduced(arch)
    params = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(
        3), device="cuda")[0]
    hp = TrainHParams(lr=1e-3, warmup=2, total_steps=10, remat="full",
                      ce_chunk=32)
    row = chip_smoke.train_twin(torch, np, cfg, params,
                                chip_smoke.train_batch(np, cfg, 2, 32), hp)
    n = chip_smoke.layer_counts(cfg)
    for key, passes in (("step_launches", 2), ("launches", 4)):
        assert (row[key]["flash_attention"], row[key]["ssd_chunk"]) == (
            passes * n["flash_attention"], passes * n["ssd_chunk"]), key


def test_regc_ranks_on_card_match_one_process_step(f32_card):
    """Two ranks share the card over gloo and take one RegC step each
    under the four policies of benchmarks/regc_training.py from the
    reduced internlm2's parameters (``chip_smoke.regc_phase`` at reduced
    width, without its launch.train run): loss, grad norm and synced
    gradients against the one-process step on the card, both ranks'
    parameters and moments equal, the counted collectives equal to the
    rule, and each step through the attention kernel."""
    import chip_smoke
    from repro_torch.configs import get_reduced
    cfg = get_reduced("internlm2-1.8b")
    rows, launches = chip_smoke.regc_phase(
        torch, np, chip_smoke.card_line(), cfg=cfg, seq=64, launch=False)
    per_step = 2 * chip_smoke.REGC_MICRO  # forward and remat, a microbatch
    assert launches["flash_attention"] == per_step * (
        1 + chip_smoke.REGC_RANKS * len(chip_smoke.REGC_POLICIES))
    for r in rows["ranks"]:
        assert r["device"].startswith("cuda")
        for tag, row in r["rows"].items():
            assert row["ranks_equal"] and row["counts_ok"], tag
            assert row["staged"]["messages"] > 0, tag     # gloo: host copies


@pytest.mark.parametrize("backend", ("kernels", "fused"))
def test_cuda_kv_serving_matches_cpu(dev, backend):
    """The serving workload (slice F) at W=16 under benchmarks/
    kv_serving.py's settings on the card and on the CPU, both drivers:
    traffic, clocks, stats and the whole report equal."""
    kw = dict(tok_words=64, max_tokens=96, attn_window=32, n_tenants=16,
              burst_mean=2, gap_max=2, seed=7)
    for driver in ("batched", "loop"):
        runs = []
        for device in (dev, "cpu"):
            rt = make_runtime(16, fetch_batch=16, cache_pages=4,
                              backend=backend, device=device)
            runs.append((rt, apps.kv_serving(rt, 48, driver=driver, **kw)))
        (card, rc), (cpu, rh) = runs
        assert dataclasses.asdict(card.traffic) == dataclasses.asdict(
            cpu.traffic)
        assert card.clock.tobytes() == cpu.clock.tobytes()
        assert card.stats == cpu.stats
        assert [dataclasses.astuple(r) for r in rc.requests] == \
            [dataclasses.astuple(r) for r in rh.requests]


@pytest.mark.parametrize("seed", (1, 2))
def test_cuda_chaos_recovery_matches_cpu(dev, seed, tmp_path):
    """A chaos trace (slice F) recovered through ``ChaosHarness`` on the
    card lands bit-equal to the uninjected run on the CPU, both drivers;
    its checkpoints restore on the card."""
    from repro_torch.dsm.costmodel import ChaosNet
    from repro_torch.ft import (ChaosHarness, FailureInjector,
                                StragglerMonitor, assert_bit_equal,
                                run_uninjected)
    p = trace_fuzz.chaos_trace_params(seed)
    rng = p["rng"]
    prog = (trace_fuzz.gen_span_program(rng, p["W"], p["n_words"],
                                        p["page_words"], p["cache_pages"],
                                        n_phases=5, n_regions=3)
            if seed % 2 else
            trace_fuzz.gen_program(rng, p["W"], p["n_words"],
                                   p["page_words"], n_phases=5))
    n = p["n_words"]

    def maker(device):
        return lambda: make_runtime(
            p["W"], page_words=p["page_words"], protocol=p["proto"],
            prefetch=1, model_mechanism=False, cache_pages=p["cache_pages"],
            backend="fused", device=device,
            chaos=ChaosNet(seed=seed, drop_rate=p["drop"]),
            straggler=StragglerMonitor(p["W"], window=4, patience=1))
    for d in ("batched", "loop"):
        base = run_uninjected(maker("cpu"), [n, n, n], d, prog,
                              trace_fuzz.apply_event)
        inj = FailureInjector(at_steps=[2, len(prog) - 1])
        rt, rep = ChaosHarness(maker(dev), [n, n, n], d, tmp_path / d,
                               trace_fuzz.apply_event,
                               injector=inj).run(prog)
        assert rep.n_crashes == 2 and rt.device.type == "cuda"
        assert_bit_equal(rt, base, (seed, d))


def _cluster_program(seed):
    """A ``cluster_trace_params`` span program with spill (its params and
    program, as the cluster suites draw them)."""
    p = trace_fuzz.cluster_trace_params(seed)
    prog = trace_fuzz.gen_span_program(p["rng"], p["W"], p["n_words"],
                                       p["page_words"], p["cache_pages"],
                                       n_phases=4)
    cfg = dict(n_workers=p["W"], page_words=p["page_words"],
               protocol=p["proto"], cache_pages=p["cache_pages"],
               backend="fused", chaos=dict(seed=seed, drop_rate=0.1),
               straggler=dict(n_workers=p["W"], window=4, k=4.0,
                              abs_floor_s=1e-4, patience=1))
    return cfg, prog, p["n_words"]


def test_cuda_cluster_matches_single_process(dev, tmp_path):
    """A 2-shard cluster on the card (slice G), with a SIGKILL and a
    reply partition recovered by respawn, finishes bit-equal to a
    single-process run on the card and in lockstep with its digests;
    every shard runs on the card and launches the fused flush."""
    from repro_torch.cluster import ClusterRuntime, make_runtime as shard_rt
    from repro_torch.cluster import state_digest
    from repro_torch.ft import FailureInjector, assert_bit_equal
    from repro_torch.ft.coherence import harness_ticks
    cfg, prog, n = _cluster_program(1)
    base = shard_rt(cfg)
    assert base.device.type == "cuda"
    gas = [base.alloc(n), base.alloc(n)]
    digests = {}
    for i, ev in enumerate(prog):
        if harness_ticks(ev, "batched"):
            base.chaos_tick()
        trace_fuzz.apply_event(base, ev, gas, "batched")
        digests[i] = state_digest(base)
    inj = FailureInjector(cluster_at=[("kill", 4, 1),
                                      ("partition_s2c", len(prog) - 2, 0)])
    with ClusterRuntime(cfg, [n, n], n_shards=2, driver="batched",
                        apply_ref=("trace_fuzz", "apply_event"),
                        root=tmp_path, injector=inj, rpc_timeout_s=1.5,
                        rpc_attempts=3) as cl:
        res = cl.run(prog)
        got = dict(cl.digests)
    assert_bit_equal(res, base, "cluster on the card")
    assert got == digests
    c = res.report.counters()
    assert (c["rec_kills"], c["rec_partitions"], c["rec_detections"],
            c["rec_respawns"]) == (1, 1, 2, 2), c
    assert res.devices == {0: "cuda", 1: "cuda"}
    assert res.stats["fused_dispatches"] == base.stats["fused_dispatches"]
    assert res.launches["phase_step"] > 0 and not res.launches["pack_rows"]


@pytest.mark.parametrize("seed", (0, 1, 4))
def test_cuda_snapshot_slices_match_cpu(dev, seed):
    """``snapshot(rows=)`` on the card (planes sliced on the device)
    equals the CPU's arrays, name, dtype and value."""
    for detect in (False, True):
        cfg, prog, n = _cluster_program(seed)
        cfg["detect_races"] = detect
        rts = {}
        for d in ("cpu", "cuda"):
            rt = make_runtime(cfg["n_workers"], page_words=cfg["page_words"],
                              protocol=cfg["protocol"],
                              cache_pages=cfg["cache_pages"],
                              backend="fused", detect_races=detect, device=d)
            gas = [rt.alloc(n), rt.alloc(n)]
            for ev in prog:
                trace_fuzz.apply_event(rt, ev, gas, "batched")
            rts[d] = rt
        W = cfg["n_workers"]
        for rows in ((0, W // 2), (W // 2, W), (1, W - 1)):
            a, m = rts["cuda"].snapshot(rows=rows)
            b, mb = rts["cpu"].snapshot(rows=rows)
            assert m == mb
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cuda_composed_checkpoint_restores_on_cpu(dev):
    """Slices taken on the card, composed, restore on the CPU; the
    restored runtime and the card's own finish the trace bit-equal."""
    from repro_torch.core import RegCScaleRuntime
    from repro_torch.ft import assert_bit_equal
    cfg, prog, n = _cluster_program(4)
    rt = make_runtime(cfg["n_workers"], page_words=cfg["page_words"],
                      protocol=cfg["protocol"], cache_pages=cfg["cache_pages"],
                      backend="fused", device=dev)
    gas = [rt.alloc(n), rt.alloc(n)]
    cut = max(i for i, ev in enumerate(prog) if ev[0] == "barrier"
              and i < len(prog) - 1) + 1
    for ev in prog[:cut]:
        trace_fuzz.apply_event(rt, ev, gas, "batched")
    W = cfg["n_workers"]
    bounds = np.linspace(0, W, 3).astype(int)
    arrays, meta = RegCScaleRuntime.compose_snapshots(
        [rt.snapshot(rows=(int(lo), int(hi)))
         for lo, hi in zip(bounds[:-1], bounds[1:])])
    on_cpu = RegCScaleRuntime.from_snapshot(arrays, meta, device="cpu")
    assert on_cpu.device.type == "cpu" and on_cpu.backend == "fused"
    for run in (rt, on_cpu):
        g = [run.gas_for_region(r, n) for r in range(2)]
        for ev in prog[cut:]:
            trace_fuzz.apply_event(run, ev, g, "batched")
    assert_bit_equal(on_cpu, rt, "card slices -> cpu")


def tp_trainer_rank(root: str):
    """One rank of ``test_tp_trainer_on_card``: the reduced
    moonshot-v1-16b-a3b under ``DEFAULT_RULES`` with ``moe_impl="ep"`` on
    a (1, 2) mesh (heads, experts and vocabulary split over 'model'),
    4 steps, checkpoints every 2, a failure injected at step 3."""
    from pathlib import Path
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.ft import FailureInjector
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import sharding as SH
    from repro_torch.train.train_step import TrainHParams, gather_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.tree import tree_flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device("cuda")
    cfg = get_reduced("moonshot-v1-16b-a3b")
    ctx = SH.ShardingCtx(make_host_mesh((1, 2), ("data", "model")),
                         SH.DEFAULT_RULES, moe_impl="ep")
    hp = TrainHParams(lr=1e-3, warmup=2, total_steps=4, remat=None,
                      ce_chunk=32)
    tc = TrainerConfig(total_steps=4, ckpt_every=2, log_every=1000,
                       ckpt_dir=str(Path(root) / "ckpts"))
    data = DataConfig(kind="synthetic", vocab_size=cfg.vocab_size,
                      seq_len=32, global_batch=4)
    out = Trainer(cfg, hp, tc, data, ctx=ctx,
                  injector=FailureInjector(at_steps=[3]),
                  log_fn=lambda *_: None, device=dev).run()
    full = gather_state(cfg, ctx, out["params"])
    return {"device": str(out["params"]["embed"].device),
            "step": out["step"], "restarts": out["restarts"],
            "losses": [h["loss"] for h in out["history"]],
            "final": {k: v.cpu().numpy() for k, v in tree_flatten(full)}}


def test_tp_trainer_on_card(f32_card, tmp_path):
    """``Trainer(ctx=)`` on two ranks sharing the card over gloo (slice
    K): both ranks restart once and end at step 4 with the same losses,
    on the card; the last checkpoint holds the gathered tree in the
    reference's layout (leaves named by its keystr paths), which the
    one-process port restores bit for bit."""
    from repro_torch.checkpoint import load_arrays, restore_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models.model import param_specs
    from repro_torch.train.train_step import init_train_state
    from repro_torch.utils.tree import tree_flatten
    got = spawn_ranks(2, "test_torch_cuda:tp_trainer_rank", (str(tmp_path),),
                      backend="gloo", init_method=f"file://{tmp_path / 'st'}",
                      timeout_s=300)
    for g in got:
        assert g["device"].startswith("cuda")
        assert g["step"] == 4 and g["restarts"] == 1
        assert all(np.isfinite(x) for x in g["losses"])
    assert got[0]["losses"] == got[1]["losses"]
    cfg = get_reduced("moonshot-v1-16b-a3b")
    arrays, _ = load_arrays(tmp_path / "ckpts", 4)
    names = [k for k, _ in tree_flatten(param_specs(cfg))]
    assert {k[len("['params']"):] for k in arrays
            if k.startswith("['params']")} == set(names)
    params, opt = init_train_state(cfg, device="cpu")
    state = restore_checkpoint(tmp_path / "ckpts", 4,
                               {"params": params, "opt": opt})
    for k, v in tree_flatten(state["params"]):
        np.testing.assert_array_equal(v.numpy(), got[0]["final"][k],
                                      err_msg=k)


def serve_tp_rank(prompt, max_new):
    """One rank of ``test_serve_tp_on_card``: the reduced
    jamba-1.5-large-398b (SSD, attention and MoE layers) under
    ``DECODE_2D_RULES`` with ``gather_fsdp=False`` on a (2, 1) mesh
    (d_model and the KV cache's positions split over 'data'), its blocks
    of the seeded parameters on the card: the prefill's logits and
    launches, then ``generate(ctx=)``'s tokens."""
    import dataclasses as dc
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import collectives as C
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import init_model_params, param_specs
    from repro_torch.serve.decode import generate, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device("cuda")
    cfg = get_reduced("jamba-1.5-large-398b")
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=4.0))
    ctx = SH.ShardingCtx(make_host_mesh((2, 1), ("data", "model")),
                         SH.DECODE_2D_RULES, gather_fsdp=False)
    full = init_model_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    params = SH.shard_params(full, ctx, SH.param_shardings(param_specs(cfg),
                                                           ctx))
    del full
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    fa.reset_launches()
    sc.reset_launches()
    C.reset_collectives()
    with torch.no_grad():
        logits, caches = make_prefill_step(
            cfg, ctx, max_len=prompt.shape[1] + max_new,
            cache_dtype=torch.float32)(params, batch)
        launches = {**fa.LAUNCHES, **sc.LAUNCHES}
        tokens = generate(cfg, params, batch, max_new_tokens=max_new,
                          ctx=ctx, device=dev)
    return {"device": str(logits.device), "logits": logits.cpu().numpy(),
            "tokens": tokens.cpu().numpy(), "launches": launches,
            "param_gathers": C.PARAM_GATHERS["messages"],
            "kv_positions": caches[4][0].shape[2]}


def test_serve_tp_on_card(f32_card, tmp_path):
    """Serving under a ctx on two ranks sharing the card over gloo
    (slice L): the reduced jamba under the no-regather decode table
    against one process on the card: prefill logits within 1e-4, the
    same greedy tokens on both ranks and in one process, the kernels
    launched once per attention or SSD layer in each rank's prefill, no
    parameter gathered, each rank holding half the KV cache's
    positions."""
    import dataclasses as dc
    from repro_torch.configs import get_reduced
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models.model import init_model_params
    from repro_torch.serve.decode import generate, make_prefill_step
    cfg = get_reduced("jamba-1.5-large-398b")
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=4.0))
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 24)).astype(np.int32)
    got = spawn_ranks(2, "test_torch_cuda:serve_tp_rank", (prompt, 6),
                      backend="gloo", init_method=f"file://{tmp_path / 'st'}",
                      timeout_s=300)
    params = init_model_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda")
    batch = {"tokens": torch.as_tensor(prompt, device="cuda")}
    with torch.no_grad():
        want, _ = make_prefill_step(cfg, max_len=30,
                                    cache_dtype=torch.float32)(params, batch)
        tokens = generate(cfg, params, batch, max_new_tokens=6,
                          device="cuda").cpu().numpy()
    for g in got:
        assert g["device"].startswith("cuda")
        np.testing.assert_allclose(g["logits"], want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g["tokens"], tokens)
        assert g["launches"] == {"flash_attention": 1, "ssd_chunk": 7}
        assert g["param_gathers"] == 0 and g["kv_positions"] == 15


def sp_train_rank(batch):
    """One rank of ``test_sp_q8_train_on_card``: the reduced mamba2-2.7b
    (two super-blocks) under ``TRAIN_SP_RULES`` on a (1, 2) mesh (the
    residual's saved positions and the SSD inner dim over 'model'),
    ``adamw8bit``, remat "full": its blocks of the seeded parameters on
    the card, one step; the gathered gradients, parameters and int8
    state, and the launches."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import rank_device
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import init_model_params
    from repro_torch.optim.quantized import init_opt_state_q8
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import tree_flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device("cuda")
    cfg = get_reduced("mamba2-2.7b", n_periods=2)
    ctx = SH.ShardingCtx(make_host_mesh((1, 2), ("data", "model")),
                         SH.TRAIN_SP_RULES)
    full = init_model_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    lp, lo = T.shard_state(cfg, ctx, full, init_opt_state_q8(full))
    del full
    hp = T.TrainHParams(remat="full", ce_chunk=32, opt_impl="adamw8bit")
    sc.reset_launches()
    p2, o2, m, g = T.make_train_step(cfg, hp, ctx)(
        lp, lo, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
        0, with_grads=True)
    launches = dict(sc.LAUNCHES)
    fg = T.gather_state(cfg, ctx, g)
    fp, fo = T.gather_state(cfg, ctx, p2, o2)
    flat = lambda t: {k: v.cpu().numpy() for k, v in  # noqa: E731
                      tree_flatten(t)}
    return {"device": str(p2["embed"].device), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "launches": launches,
            "grads": flat(fg), "params": flat(fp), "opt": flat(fo)}


def test_sp_q8_train_on_card(f32_card, tmp_path):
    """Training under the serving half's mechanisms on two ranks sharing
    the card over gloo (slice M): the reduced mamba2 under
    ``TRAIN_SP_RULES`` with ``adamw8bit`` against one process on the
    card: loss within 1e-5 relative, grad norm and every gradient leaf
    within 1e-4 (of the leaf's largest value), parameters at rtol 5e-3 /
    atol 5e-5, int8 scales within 1e-5 relative and codes within 1, both
    ranks alike, ssd_chunk launched twice a layer (forward and remat)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.ranks import spawn_ranks
    from repro_torch.models.model import init_model_params
    from repro_torch.optim.quantized import init_opt_state_q8
    from repro_torch.train import train_step as T
    from repro_torch.utils.tree import tree_flatten
    cfg = get_reduced("mamba2-2.7b", n_periods=2)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
             for k in ("tokens", "targets")}
    got = spawn_ranks(2, "test_torch_cuda:sp_train_rank", (batch,),
                      backend="gloo", init_method=f"file://{tmp_path / 'st'}",
                      timeout_s=300)
    params = init_model_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda")
    hp = T.TrainHParams(remat="full", ce_chunk=32, opt_impl="adamw8bit")
    p1, o1, m1, g1 = T.make_train_step(cfg, hp)(
        params, init_opt_state_q8(params),
        {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}, 0,
        with_grads=True)
    assert got[0]["loss"] == got[1]["loss"]
    for g in got:
        assert g["device"].startswith("cuda")
        assert g["launches"] == {"ssd_chunk": 2 * cfg.n_layers}
        np.testing.assert_allclose(g["loss"], float(m1["loss"]), rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], float(m1["grad_norm"]),
                                   rtol=1e-4)
        for k, v in tree_flatten(g1):
            v = v.cpu().numpy()
            assert np.abs(g["grads"][k] - v).max() <= 1e-4 * max(
                np.abs(v).max(), 1e-30), k
        for k, v in tree_flatten(p1):
            np.testing.assert_allclose(g["params"][k], v.cpu().numpy(),
                                       rtol=5e-3, atol=5e-5, err_msg=k)
        for k, v in tree_flatten(o1):
            v = v.cpu().numpy()
            if v.dtype == np.int8:
                assert np.abs(g["opt"][k].astype(np.int32)
                              - v.astype(np.int32)).max() <= 1, k
            else:
                np.testing.assert_allclose(g["opt"][k], v, rtol=1e-5,
                                           err_msg=k)
