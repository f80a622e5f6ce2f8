"""The paper's applications on the RegC runtime API: STREAM TRIAD, Jacobi
(OmpSCR) and molecular dynamics (OmpSCR), as in the reference package,
plus the two capacity-pressure STREAM variants of Fig. 4
(``stream_spill``, ``stream_refetch``) that run under ``cache_pages``,
the span-engine adversary ``lock_contention``, the race detector's
workload ``race_audit`` and the KV-cache serving workload ``kv_serving``
(with its request stream ``gen_requests``).

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

import dataclasses
from typing import Callable, List, Optional

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


# ---------------------------------------------------------------------------
# KV-cache serving (fig8_kv_serving): inference traffic as a DSM workload
# ---------------------------------------------------------------------------


ADMIT_LOCK = 2


@dataclasses.dataclass
class ServeRequest:
    """One inference request in the synthetic multi-tenant stream."""
    tenant: int
    prompt_tokens: int
    decode_tokens: int
    arrival_step: int
    slot: int = -1
    admit_step: int = -1
    finish_step: int = -1
    arrival_time: float = 0.0
    finish_time: float = 0.0

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time


@dataclasses.dataclass
class ServeReport:
    """Deterministic outcome of one ``kv_serving`` run.

    Everything here is a pure function of the request stream and the
    runtime's modeled clocks, so the drivers' bit-equal-clock contract
    makes the whole report — latencies included — bit-equal across
    ``loop``/``batched`` and both backends."""
    requests: List[ServeRequest]
    steps: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    admit_spans: int = 0
    admitted: int = 0
    idle_slot_steps: int = 0
    peak_queue: int = 0

    def latencies(self) -> np.ndarray:
        done = [r.latency for r in self.requests if r.finish_step >= 0]
        return np.asarray(sorted(done), dtype=np.float64)

    def latency_pct(self, q: float) -> float:
        lat = self.latencies()
        if not lat.size:
            raise ValueError("latency_pct(): no completed requests")
        return float(np.percentile(lat, q))

    @property
    def span_time(self) -> float:
        """Modeled makespan: last finish time across completed requests."""
        return max((r.finish_time for r in self.requests
                    if r.finish_step >= 0), default=0.0)

    def tokens_per_s(self) -> float:
        t = self.span_time
        return (self.prefill_tokens + self.decode_tokens) / t if t else 0.0


def gen_requests(n_requests: int, *, n_tenants: int = 8,
                 zipf_s: float = 1.3, max_tokens: int = 96,
                 burst_mean: int = 4, gap_max: int = 3,
                 seed: int = 0) -> List[ServeRequest]:
    """Synthetic multi-tenant request stream: Zipf-skewed tenant draws
    (tenant 0 hottest), per-tenant length profiles (hot tenants chatty —
    short prompts/decodes; cold tenants long-context), and bursty
    arrivals (geometric burst sizes separated by uniform step gaps,
    arrival step = decode-step index as the time axis).  Deterministic
    in ``seed``."""
    rng = np.random.default_rng(seed)
    # Zipf over tenant ranks via inverse-CDF on the truncated harmonic
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64)
    pmf = ranks ** -zipf_s
    pmf /= pmf.sum()
    tenants = rng.choice(n_tenants, size=n_requests, p=pmf)
    # per-tenant profiles: prompt/decode budgets scale with tenant rank
    p_base = np.minimum(4 + 6 * np.arange(n_tenants), (3 * max_tokens) // 4)
    d_base = np.minimum(3 + 2 * np.arange(n_tenants), max_tokens // 4)
    reqs: List[ServeRequest] = []
    step = 0
    emitted = 0
    while emitted < n_requests:
        burst = min(int(rng.geometric(1.0 / burst_mean)),
                    n_requests - emitted)
        for _ in range(burst):
            t = int(tenants[emitted])
            dec = max(1, int(d_base[t]) + int(rng.integers(-2, 3)))
            pro = max(1, int(p_base[t]) + int(rng.integers(-3, 4)))
            pro = min(pro, max_tokens - dec)   # fits the slot KV budget
            reqs.append(ServeRequest(tenant=t, prompt_tokens=pro,
                                     decode_tokens=dec, arrival_step=step))
            emitted += 1
        step += int(rng.integers(1, gap_max + 1))
    return reqs


def kv_serving(rt, n_requests: int, *, tok_words: int = 64,
               max_tokens: int = 96, attn_window: int = 32,
               n_tenants: int = 8, zipf_s: float = 1.3,
               burst_mean: int = 4, gap_max: int = 3, seed: int = 0,
               driver: str = "auto", max_steps: int = 200_000,
               on_step: Optional[Callable] = None) -> ServeReport:
    """Continuous-batching inference fleet as a RegC program.

    Workers are decode slots; the KV cache is one GAS region of W
    page-aligned slot blocks, each ``max_tokens`` rows of ``tok_words``
    words (a slot's stacked per-layer K/V rows — the layout of
    ``serve/decode.py``'s caches, flattened time-major).  Each decode
    step runs:

    1. **admission** — queued requests claim free slots inside a span on
       ``ADMIT_LOCK`` (the continuous-batching scheduler's critical
       section; slot reuse is ordered by the lock's grant chain);
    2. **prefill** — a bulk write phase: admitting slots write their
       whole prompt's KV rows at once (idle/running slots touch one word
       of their own block — every worker participates in the SPMD
       phase);
    3. **decode** — active slots read their trailing ``attn_window`` KV
       rows (paged attention) and append one new row; idle slots touch
       one word.  One barrier per step (the batch-wide sync point).

    Slot blocks are disjoint and the queue cell is lock-guarded, so the
    program is data-race-free (``detect_races=True`` flags nothing).
    Under a ``cache_pages`` budget below a slot's working set, prefill
    ranges wider than the cache drive the mid-op danger path and the
    sliding attention window keeps batched eviction live — the
    paged-attention pressure regime the fig8 bench asserts via
    ``stats`` counters.  Requests, latencies (modeled arrival→finish
    time), and every counter are bit-equal across drivers and backends.
    """
    W = rt.W
    pw = rt.page_words
    if attn_window > max_tokens:
        raise ValueError(f"attn_window {attn_window} exceeds max_tokens "
                         f"{max_tokens}")
    slot_words = max_tokens * tok_words
    stride = -(-slot_words // pw) * pw       # page-aligned slot pitch
    kv = rt.alloc(W * stride)
    q = rt.alloc(2)                          # queue head/tail cell
    s = session(rt, driver)

    reqs = gen_requests(n_requests, n_tenants=n_tenants, zipf_s=zipf_s,
                        max_tokens=max_tokens, burst_mean=burst_mean,
                        gap_max=gap_max, seed=seed)
    rep = ServeReport(requests=reqs)

    base = np.arange(W, dtype=np.int64) * stride
    zero = np.zeros(W, np.int64)
    two = np.full(W, 2, np.int64)
    active = np.full(W, -1, np.int64)        # request index per slot
    length = np.zeros(W, np.int64)           # KV rows materialized
    remaining = np.zeros(W, np.int64)        # decode tokens left
    queue: List[int] = []
    next_arrival = 0
    completed = 0
    step = 0
    while completed < n_requests:
        if step >= max_steps:
            raise RuntimeError(f"kv_serving: no progress in {max_steps} "
                               "steps (stream starved?)")
        t_now = rt.time
        while (next_arrival < n_requests
               and reqs[next_arrival].arrival_step <= step):
            reqs[next_arrival].arrival_time = t_now
            queue.append(next_arrival)
            next_arrival += 1
        rep.peak_queue = max(rep.peak_queue, len(queue))

        # admission: free slots claim queued requests in slot order,
        # serialized through the admission lock's grant chain
        admit = np.zeros(W, bool)
        for w in range(W):
            if active[w] < 0 and queue:
                i = queue.pop(0)
                r = reqs[i]
                r.slot, r.admit_step = w, step
                active[w] = i
                length[w] = 0
                remaining[w] = r.decode_tokens
                admit[w] = True
        if admit.any():
            s.span(ADMIT_LOCK, reads=((q, zero, two),),
                   writes=((q, zero, two),), w_mask=admit)
            rep.admit_spans += 1
            rep.admitted += int(admit.sum())
            # prefill: bulk KV write of the whole prompt, one phase
            plen = np.where(
                admit,
                np.array([reqs[i].prompt_tokens if i >= 0 else 0
                          for i in active], np.int64), 0)
            w_lo = base
            w_hi = base + np.where(admit, plen * tok_words, 1)
            s.phase(writes=((kv, w_lo, w_hi),),
                    flops=2.0 * plen * tok_words,
                    mem_bytes=4.0 * plen * tok_words)
            length[admit] = plen[admit]
            rep.prefill_tokens += int(plen.sum())

        running = active >= 0
        if running.any():
            # decode: windowed attention read + one appended KV row
            win = np.where(running, np.minimum(length, attn_window), 0)
            r_lo = base + np.where(running, (length - win) * tok_words, 0)
            r_hi = r_lo + np.where(running, win * tok_words, 1)
            w_lo = base + np.where(running, length * tok_words, 0)
            w_hi = w_lo + np.where(running, tok_words, 1)
            s.phase(reads=((kv, r_lo, r_hi),), writes=((kv, w_lo, w_hi),),
                    flops=2.0 * win * tok_words,
                    mem_bytes=4.0 * (win + 1) * tok_words)
            length[running] += 1
            remaining[running] -= 1
            rep.decode_tokens += int(running.sum())
            rep.idle_slot_steps += int(W - running.sum())
        rt.barrier()
        t_end = rt.time
        done = running & (remaining == 0)
        for w in np.flatnonzero(done):
            r = reqs[int(active[w])]
            r.finish_step, r.finish_time = step, t_end
            active[w] = -1
            completed += 1
        step += 1
        rep.steps = step
        if on_step is not None:
            on_step(step, rt)
    return rep
