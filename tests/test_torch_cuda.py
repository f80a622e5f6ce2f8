"""The port's CUDA kernels and CUDA runtime against their plain versions,
on the card.  Every test here needs a CUDA device and skips without one
(marker ``gpu``).  Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerance: exact (integer kernels; clocks bit-equal, since charging runs
on the host in the same order whatever the device)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import make_runtime
from repro_torch.dsm import apps
from repro_torch.kernels import protocol_sweep as ps

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_match_plain_versions(dev):
    rng = np.random.default_rng(5)
    for W, C in ((1, 1), (3, 31), (37, 1000), (256, 16385)):
        plane = torch.as_tensor(rng.random((W, C)) < 0.4, device=dev)
        bits = ps.pack_rows(plane)
        assert torch.equal(bits, ps._pack_rows_plain(plane))
        assert torch.equal(ps.popcount_rows(bits),
                           ps._popcount_rows_plain(bits))
    for n in (1, 9, 256, 257, 5000):
        delta = torch.as_tensor(
            rng.choice(np.array([1, -1], np.int32), n), device=dev)
        assert torch.equal(ps.coverage_multi(delta),
                           ps._coverage_multi_plain(delta))
    i32max = np.iinfo(np.int32).max
    R, W, C = 3, 9, 300
    planes = torch.as_tensor(rng.random((R, W, C)) < 0.5, device=dev)
    bits = torch.stack([ps._pack_rows_plain(p) for p in planes])
    base = np.full((R, W), -1, np.int32)
    base[:, :7] = np.arange(7) * 250
    sbs = np.full((R, W), i32max, np.int32)
    ses = np.full((R, W), i32max, np.int32)
    sbs[:, :7] = base[:, :7]
    ses[:, :7] = base[:, :7] + C
    bits[:, 7:] = 0
    args = [bits] + [torch.as_tensor(a, device=dev) for a in (
        base, rng.random((R, W)) < 0.8, sbs, ses)]
    got, want = ps.phase_step(*args), ps._phase_step_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_phase_step_at_its_width_limit(dev):
    """At W = MAX_PHASE_STEP_W the staged bounds take the kernel past the
    48 KiB default shared memory (it opts in to more) and still launch;
    one row more is refused by the wrapper before launch."""
    rng = np.random.default_rng(6)
    W, nw = ps.MAX_PHASE_STEP_W, 2
    base = np.arange(W, dtype=np.int32) * 40
    bounds = np.sort(base)
    args = [torch.as_tensor(rng.integers(-2**31, 2**31, (1, W, nw),
                                         dtype=np.int64).astype(np.int32),
                            device=dev)]
    args += [torch.as_tensor(a[None], device=dev) for a in (
        base, rng.random(W) < 0.8, bounds, bounds + 64)]
    got, want = ps.phase_step(*args), ps._phase_step_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].ne(0).sum()) > 0
    wide = [torch.zeros((1, W + 1, nw), dtype=torch.int32, device=dev)]
    wide += [torch.zeros((1, W + 1), dtype=dt, device=dev)
             for dt in (torch.int32, torch.bool, torch.int32, torch.int32)]
    with pytest.raises(ValueError, match="limits"):
        ps.phase_step(*wide)


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
