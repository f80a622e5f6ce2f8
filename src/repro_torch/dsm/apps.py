"""The paper's applications on the RegC runtime API: STREAM TRIAD, Jacobi
(OmpSCR) and molecular dynamics (OmpSCR), as in the reference package,
plus the two capacity-pressure STREAM variants of Fig. 4
(``stream_spill``, ``stream_refetch``) that run under ``cache_pages``,
the span-engine adversary ``lock_contention`` and the race detector's
workload ``race_audit``.

Each bulk phase is described once as (W,) interval arrays — the workers'
read/write sets declared up front — and handed to a ``dsm.session``
driver (``batched`` = the engine's ``phase_all``/``span_all``; ``loop`` =
per-worker phases and spans in worker order).  Consistency-region spans
(lock mode) run as one pass AFTER the bulk phase, so the op order is
identical whichever driver executes the bulk part.

Jacobi and MD take ``mode``:
* ``lock``       — global accumulators protected by a mutex (consistency
  region), the paper's threaded port;
* ``reduction``  — the paper's §V-B extension: ``reduce`` replaces the
  mutex-accumulate pattern.

Compute costs are charged via per-phase flop/byte counts; ALL protocol
traffic is exact.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.dsm.session import session

RES_LOCK = 0
ENERGY_LOCK = 1
MODES = ("lock", "reduction")


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"invalid mode={mode!r}; allowed: {MODES}")


def _blocks(n: int, W: int):
    """Block partition of [0, n): (W,) lo/hi arrays, last worker takes the
    remainder (the paper's static OpenMP-style schedule)."""
    chunk = n // W
    lo = np.arange(W, dtype=np.int64) * chunk
    hi = lo + chunk
    hi[-1] = n
    return lo, hi


def stream_triad(rt, n: int, iters: int, *, driver: str = "auto",
                 on_iter: Optional[Callable] = None):
    """A = B + alpha*C, one barrier per iteration (paper §V-A)."""
    A, B, C = rt.alloc(n), rt.alloc(n), rt.alloc(n)
    lo, hi = _blocks(n, rt.W)
    phase = session(rt, driver).phase
    flops = 2.0 * (hi - lo)
    mem_bytes = 3.0 * 4 * (hi - lo)
    for it in range(iters):
        phase(reads=((B, lo, hi), (C, lo, hi)), writes=((A, lo, hi),),
              flops=flops, mem_bytes=mem_bytes)
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt


def triad_bytes_per_iter(n: int) -> float:
    return 3.0 * 4 * n


def stream_spill(rt, n: int, iters: int, *, sweeps: int = 2,
                 rotate: bool = True, driver: str = "auto",
                 on_iter: Optional[Callable] = None):
    """Capacity-pressure STREAM (paper Fig. 4, the spill-heavy series):
    every barrier epoch runs ``sweeps`` read+write passes, and with
    ``rotate`` each pass shifts the block assignment by one (worker w
    takes block ``(w + pass) % W``), so each worker's dirty block lands in
    its neighbours' reach: under a small cache the interacting workers
    replay in tick order.  ``rotate=False`` keeps blocks disjoint (fully
    batched eviction)."""
    A, B = rt.alloc(n), rt.alloc(n)
    W = rt.W
    chunk = n // W
    ids = np.arange(W, dtype=np.int64)
    phase = session(rt, driver).phase
    for it in range(iters):
        for s in range(sweeps):
            r = (ids + it * sweeps + s) % W if rotate else ids
            lo = r * chunk
            hi = np.where(r == W - 1, n, lo + chunk)
            phase(reads=((B, lo, hi),), writes=((A, lo, hi),),
                  flops=2.0 * (hi - lo), mem_bytes=2.0 * 4 * (hi - lo))
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt


def stream_refetch(rt, n: int, iters: int, *, sweeps: int = 2,
                   width_pages: int = 8, driver: str = "auto",
                   on_iter: Optional[Callable] = None):
    """Mid-op refetch pressure (paper Fig. 4's refetch series): each worker
    owns a disjoint block and every pass slides a read+write window
    across it by half the window width, under a cache that holds barely
    more than one window pair, so every op half-overlaps pages still in
    cache while its cold half pushes occupancy over the watermark: the
    evict-then-refetch interleave of the danger path."""
    A, B = rt.alloc(n), rt.alloc(n)
    W = rt.W
    chunk = n // W
    Lw = width_pages * rt.page_words        # window width in words
    if chunk < 2 * Lw:
        raise ValueError(f"stream_refetch: blocks of {chunk} words cannot "
                         f"hold a sliding window of {Lw}")
    step = Lw // 2
    n_offs = (chunk - Lw) // step + 1       # window positions per block
    ids = np.arange(W, dtype=np.int64)
    phase = session(rt, driver).phase
    k = 0
    for it in range(iters):
        for s in range(sweeps):
            off = (k * step) % (n_offs * step)
            k += 1
            lo = ids * chunk + off
            hi = lo + Lw
            phase(reads=((B, lo, hi),), writes=((A, lo, hi),),
                  flops=2.0 * (hi - lo), mem_bytes=2.0 * 4 * (hi - lo))
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt


def jacobi(rt, n: int, iters: int, *, mode: str = "lock",
           driver: str = "auto", on_iter: Optional[Callable] = None):
    """5-point stencil on an n x n grid; per-iteration global residual.

    Phases per iteration (3 barriers, as in the paper):
      1. uold = u                  (ordinary stores, own block)
      2. u = stencil(uold, f); local residual; global accumulate
         (consistency region in 'lock' mode / runtime reduction otherwise)
      3. all workers read the residual (convergence test)
    """
    _check_mode(mode)
    W = rt.W
    u = rt.alloc(n * n)
    uold = rt.alloc(n * n)
    f = rt.alloc(n * n)
    res = rt.alloc(1)          # global residual accumulator (one word)
    r0, r1 = _blocks(n, W)     # row blocks
    lo_b, hi_b = r0 * n, r1 * n
    lo_h = np.maximum(r0 - 1, 0) * n         # halo rows from neighbours
    hi_h = np.minimum(r1 + 1, n) * n
    pts = (r1 - r0) * n
    zero = np.zeros(W, np.int64)
    one = np.ones(W, np.int64)
    s = session(rt, driver)
    phase, span_phase = s.phase, s.span

    for it in range(iters):
        # phase 1: copy own block u -> uold
        phase(reads=((u, lo_b, hi_b),), writes=((uold, lo_b, hi_b),),
              mem_bytes=2.0 * 4 * (hi_b - lo_b))
        rt.barrier()

        # phase 2: stencil + residual (~13 adds/muls + one fp division
        # per point: ~50 flop-equivalents scalar), then the accumulate
        phase(reads=((uold, lo_h, hi_h), (f, lo_b, hi_b)),
              writes=((u, lo_b, hi_b),),
              flops=50.0 * pts, mem_bytes=4.0 * 4 * pts)
        if mode == "lock":
            span_phase(RES_LOCK, reads=((res, zero, one),),
                       writes=((res, zero, one),))
        else:
            s.reduce("residual")
        rt.barrier()

        # phase 3: convergence test — everyone reads the residual
        if mode == "lock":
            phase(reads=((res, zero, one),))
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt


def jacobi_flops_per_iter(n: int) -> float:
    return 50.0 * n * n


def molecular_dynamics(rt, n_particles: int, iters: int, *,
                       mode: str = "lock", ndim: int = 3,
                       driver: str = "auto",
                       on_iter: Optional[Callable] = None):
    """Velocity-Verlet n-body with a central pair potential.

    Phase A (forces): every worker reads ALL positions, writes the force
    rows of its own particles, and accumulates potential+kinetic energy
    into globals (mutex / reduction).  O(n^2/W) interactions per worker.
    Phase B (update): positions/velocities/accelerations of own particles.
    """
    _check_mode(mode)
    W = rt.W
    nw = n_particles * ndim
    pos = rt.alloc(nw)
    vel = rt.alloc(nw)
    acc = rt.alloc(nw)
    force = rt.alloc(nw)
    energy = rt.alloc(2)       # [potential, kinetic]
    p0, p1 = _blocks(n_particles, W)
    lo_w, hi_w = p0 * ndim, p1 * ndim        # own word blocks
    inter = (p1 - p0) * n_particles
    zero = np.zeros(W, np.int64)
    two = np.full(W, 2, np.int64)
    all_w = np.full(W, nw, np.int64)
    s = session(rt, driver)
    phase, span_phase = s.phase, s.span

    for it in range(iters):
        # phase A: forces + energies (~60 flop-equivalents per pair); the
        # pair loop's 3-vector force stores are instrumented under `fine`
        phase(reads=((pos, zero, all_w),                 # all positions
                     (vel, lo_w, hi_w)),                 # own vel (KE)
              writes=((force, lo_w, hi_w),),
              flops=60.0 * inter,
              mem_bytes=4.0 * (nw + 2.0 * (hi_w - lo_w)),
              instr_words=3.0 * inter)
        if mode == "lock":
            span_phase(ENERGY_LOCK, reads=((energy, zero, two),),
                       writes=((energy, zero, two),))
        else:
            s.reduce("potential")
            s.reduce("kinetic")
        rt.barrier()

        # phase B: velocity-Verlet update of own particles
        phase(reads=((pos, lo_w, hi_w), (vel, lo_w, hi_w),
                     (acc, lo_w, hi_w), (force, lo_w, hi_w)),
              writes=((pos, lo_w, hi_w), (vel, lo_w, hi_w),
                      (acc, lo_w, hi_w)),
              flops=12.0 * (hi_w - lo_w), mem_bytes=7.0 * 4 * (hi_w - lo_w))
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt


def md_flops_per_iter(n_particles: int) -> float:
    return 60.0 * n_particles * n_particles


# ---------------------------------------------------------------------------
# Lock contention (span-engine adversary: hot lock + disjoint lock striping)
# ---------------------------------------------------------------------------


def lock_contention(rt, n: int, iters: int, *, n_locks: int = 8,
                    sweeps: int = 1, driver: str = "auto",
                    on_iter: Optional[Callable] = None):
    """Adversarial consistency-region workload for the span engine.

    Each iteration runs one bulk ordinary phase (read+write of the
    worker's own block, so every span pass starts with real flush work
    to hoist), then ``sweeps`` x two span passes:

    * **striped**: worker w serializes on lock ``w % n_locks``,
      accumulating into that lock's private page: ``n_locks``
      independent grant chains of W/n_locks holders each;
    * **hot**: every worker serializes through ONE global lock updating
      one shared accumulator pair: the longest grant chain, where only
      the per-holder work around the grant can batch.

    Both passes are uniform per lock group, so the batched driver's
    analytic group path (``span_all``) absorbs them entirely
    (``stats['span_groups_vec']`` counts it).  Bit-exact across
    drivers."""
    if n_locks < 1:
        raise ValueError(f"lock_contention: n_locks={n_locks} < 1")
    W = rt.W
    pw = rt.page_words
    A = rt.alloc(n)
    acc = rt.alloc(n_locks * pw)       # one private page per striped lock
    hot = rt.alloc(2)                  # the global accumulator pair
    ids = np.arange(W, dtype=np.int64)
    lo, hi = _blocks(n, W)
    stripe = (ids % n_locks).astype(np.int64)
    s_lo = stripe * pw
    s_hi = s_lo + 2
    zero = np.zeros(W, np.int64)
    two = np.full(W, 2, np.int64)
    hot_lock = n_locks                 # distinct from every striped lock
    s = session(rt, driver)
    phase, span_phase = s.phase, s.span
    for it in range(iters):
        phase(reads=((A, lo, hi),), writes=((A, lo, hi),),
              flops=4.0 * (hi - lo), mem_bytes=2.0 * 4 * (hi - lo))
        for _ in range(sweeps):
            span_phase(stripe, reads=((acc, s_lo, s_hi),),
                       writes=((acc, s_lo, s_hi),))
            span_phase(hot_lock, reads=((hot, zero, two),),
                       writes=((hot, zero, two),))
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt


def race_audit(rt, n: int, iters: int, *, n_locks: int = 4,
               driver: str = "auto", on_iter: Optional[Callable] = None):
    """Mixed clean and racy workload for the race detector (fig11_races):
    real protocol traffic with a known, deterministic set of data races.

    Each iteration runs

    * a bulk ordinary phase on the worker's own block (clean);
    * a striped span pass: lock ``w % n_locks`` guards that lock's
      private accumulator page (clean: same-lock accesses are ordered);
    * the audit targets: a write of the own block followed, with the
      barrier deliberately left out, by a read of the NEXT worker's block
      (an unordered write-to-read handoff: one ``rw`` race per shared
      page), and pairwise writes to a shared scratch page with no lock at
      all (one ``ww`` race per worker pair);
    * a barrier closing the iteration.

    The flagged set saturates after the first iteration (each race counts
    once), so ``race_ww``/``race_rw`` are deterministic.  With
    ``detect_races=False`` the program is the detector-off baseline:
    traffic and clocks bit-equal to the detecting run."""
    if n_locks < 1:
        raise ValueError(f"race_audit: n_locks={n_locks} < 1")
    W = rt.W
    pw = rt.page_words
    A = rt.alloc(n)
    acc = rt.alloc(n_locks * pw)       # one private page per striped lock
    pairs = rt.alloc(((W + 1) // 2) * pw)  # one shared page per pair
    ids = np.arange(W, dtype=np.int64)
    lo, hi = _blocks(n, W)
    nb_lo, nb_hi = np.roll(lo, -1), np.roll(hi, -1)   # block of (w+1)%W
    stripe = (ids % n_locks).astype(np.int64)
    s_lo = stripe * pw
    s_hi = s_lo + 2
    pr_lo = (ids // 2) * pw
    pr_hi = pr_lo + 2
    s = session(rt, driver)
    phase, span_phase = s.phase, s.span
    for it in range(iters):
        phase(reads=((A, lo, hi),), writes=((A, lo, hi),),
              flops=2.0 * (hi - lo))
        span_phase(stripe, reads=((acc, s_lo, s_hi),),
                   writes=((acc, s_lo, s_hi),))
        phase(writes=((A, lo, hi),))
        phase(reads=((A, nb_lo, nb_hi),))   # no barrier: unordered handoff
        phase(writes=((pairs, pr_lo, pr_hi),))  # no lock: pairwise W/W
        rt.barrier()
        if on_iter is not None:
            on_iter(it, rt)
    return rt
