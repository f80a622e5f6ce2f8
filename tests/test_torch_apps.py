"""The paper's applications on the port against the reference: STREAM
TRIAD, and Jacobi and molecular dynamics in both lock and reduction
modes, at W in {4, 16} and small sizes, with the benchmark harness's
settings (IB_2013, fetch_batch=16).

Each point runs on the reference (numpy tier) and on every port tier
(``device="cpu"``) under the same driver.  In lock mode both batched
drivers run their spans through ``span_all`` (the loop drivers through
the per-worker span body), so the span engine's path counters
(``span_*`` in ``stats``) must match as well as traffic and clocks.
The capacity-pressure points (``stream_spill``, ``stream_refetch`` and
the spill settings of Jacobi and MD) run the same way under the
harness's cache rules, with 64-word pages so that small problems keep the
harness's page geometry; there ``stats`` (the danger and eviction path
counters) must match too.

Tolerance: traffic exact, clocks and reduction results bit-equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import make_runtime as ref_make
from repro.dsm import apps as ref_apps
from repro.dsm.costmodel import IB_2013 as REF_IB
from repro_torch.core import make_runtime as pt_make
from repro_torch.dsm import apps as pt_apps
from repro_torch.dsm.costmodel import IB_2013 as PT_IB

# (app, mode, size, page_words): STREAM elements, Jacobi grid side, MD
# particles; 16-word pages give the acquire flush more than 64 dirty pages
# per worker (the wide sharer-invalidation path)
CASES = [("stream_triad", None, 1 << 15, 1024), ("jacobi", "lock", 96, 1024),
         ("jacobi", "lock", 96, 16), ("jacobi", "reduction", 96, 1024),
         ("molecular_dynamics", "lock", 512, 1024),
         ("molecular_dynamics", "reduction", 512, 1024)]
PROTOS = ("fine", "page", "ideal")


def _run(mod, rt, app, mode, n, driver):
    kw = {} if mode is None else {"mode": mode}
    getattr(mod, app)(rt, n, 3, driver=driver, **kw)
    return rt


@pytest.mark.parametrize("W", (4, 16))
@pytest.mark.parametrize("app,mode,n,pw", CASES,
                         ids=[f"{a}-{m}-{pw}" for a, m, _, pw in CASES])
def test_app_matches_reference(app, mode, n, pw, W):
    for proto in PROTOS:
        for driver in ("batched", "loop"):
            ref = _run(ref_apps, ref_make(W, protocol=proto, cost=REF_IB,
                                          fetch_batch=16, page_words=pw),
                       app, mode, n, driver)
            for backend in ("plain", "kernels", "fused"):
                pt = _run(pt_apps, pt_make(W, protocol=proto, cost=PT_IB,
                                           fetch_batch=16, page_words=pw,
                                           backend=backend, device="cpu"),
                          app, mode, n, driver)
                ctx = (app, mode, W, proto, driver, backend)
                assert (dataclasses.asdict(pt.traffic)
                        == dataclasses.asdict(ref.traffic)), ctx
                np.testing.assert_allclose(pt.clock, ref.clock, rtol=0,
                                           atol=0, err_msg=str(ctx))
                for name in ref._reduction_results:
                    assert (pt.reduction_result(name)
                            == ref.reduction_result(name)), ctx
                if mode == "lock":
                    assert ({k: v for k, v in pt.stats.items()
                             if k.startswith("span_")}
                            == {k: v for k, v in ref.stats.items()
                                if k.startswith("span_")}), ctx
                    assert (pt.stats["span_workers_vec"] > 0) == (
                        driver == "batched"), ctx


def _spill_case(app, W):
    """(app, kwargs, cache_pages, n) of one spill point: the harness's
    cache rules (benchmarks/{stream_triad,jacobi,molecular_dynamics}.py)
    at 64-word pages."""
    pw = 64
    if app in ("stream_spill", "stream_refetch"):
        n = (1 << 13) * W                       # 128 pages per worker
        if app == "stream_spill":
            return {"sweeps": 2}, (3 * (n // pw)) // (2 * W), n
        return {"sweeps": 2, "width_pages": 8}, 20, n
    if app == "jacobi":
        n = 96
        return ({"mode": "reduction"},
                max((3 * (n * n // pw)) // (2 * W), 8), n)
    n = 512
    return {"mode": "reduction"}, max(-(-(n * 3) // pw) // 2, 4), n


SPILL_APPS = ("stream_spill", "stream_refetch", "jacobi",
              "molecular_dynamics")


@pytest.mark.parametrize("W", (4, 16))
@pytest.mark.parametrize("app", SPILL_APPS)
def test_spill_app_matches_reference(app, W):
    kw, cache_pages, n = _spill_case(app, W)
    cfg = dict(protocol="fine", fetch_batch=16, page_words=64,
               cache_pages=cache_pages)
    for driver in ("batched", "loop"):
        ref = ref_make(W, cost=REF_IB, **cfg)
        getattr(ref_apps, app)(ref, n, 2, driver=driver, **kw)
        for backend in ("plain", "kernels", "fused"):
            pt = pt_make(W, cost=PT_IB, backend=backend, device="cpu",
                         **cfg)
            getattr(pt_apps, app)(pt, n, 2, driver=driver, **kw)
            ctx = (app, W, driver, backend)
            assert (dataclasses.asdict(pt.traffic)
                    == dataclasses.asdict(ref.traffic)), ctx
            np.testing.assert_allclose(pt.clock, ref.clock, rtol=0, atol=0,
                                       err_msg=str(ctx))
            assert {k: v for k, v in pt.stats.items() if k in ref.stats
                    and not k.startswith("jit_")} == {
                k: v for k, v in ref.stats.items()
                if not k.startswith("jit_")}, ctx
            for name in ref._reduction_results:
                assert (pt.reduction_result(name)
                        == ref.reduction_result(name)), ctx
        if app == "stream_refetch" and driver == "batched":
            # every op of the refetch adversary is danger-flagged
            assert ref.stats["danger_vec_ops"] > 0


def test_refetch_rejects_blocks_too_small():
    rt = pt_make(4, device="cpu", page_words=64, cache_pages=20)
    with pytest.raises(ValueError, match="sliding window"):
        pt_apps.stream_refetch(rt, 4 * 64 * 8, 1)


def test_block_partition_matches():
    for n, W in ((10, 3), (4096, 256), (7, 7)):
        for got, want in zip(pt_apps._blocks(n, W), ref_apps._blocks(n, W)):
            np.testing.assert_array_equal(got, want)
    for fn, arg in (("triad_bytes_per_iter", 99),
                    ("jacobi_flops_per_iter", 64), ("md_flops_per_iter", 80)):
        assert getattr(pt_apps, fn)(arg) == getattr(ref_apps, fn)(arg)


def test_invalid_mode_raises():
    rt = pt_make(2, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        pt_apps.jacobi(rt, 8, 1, mode="atomic")
