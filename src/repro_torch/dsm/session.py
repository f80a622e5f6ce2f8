"""Public SPMD driver façade over a RegC runtime.

``session(rt, driver=...)`` returns a :class:`Session` whose named
callables drive whole declared-access phases — the programming surface
the apps use:

* ``s.phase(reads=..., writes=..., flops=..., ...)`` — one bulk ordinary
  phase.  Interval tuples are ``(ga, lo, hi)`` with (W,) int arrays;
  flops/mem_bytes/seconds/instr_words scalars or (W,) arrays.
* ``s.span(lock_ids, reads=..., writes=..., w_mask=None)`` — one whole
  consistency-region pass: every masked worker acquires its lock, runs
  the declared interval ops inside the span, and releases.
* ``s.reduce(name, value=1.0)`` — per-worker reduction contribution
  (the paper's §V-B extension).
* ``s.barrier()`` — delegate to ``rt.barrier()``.

Drivers: ``batched`` routes phases and spans through the scale engine's
worker-axis ``phase_all`` and ``span_all``; ``loop`` issues per-worker
phases in worker order, as ``rt.phase`` where the runtime has one and as
per-op ``read``/``write``/``compute``/``instr_stores`` otherwise, and
per-worker spans (acquire, the declared ops, release) in worker order.
``auto`` picks ``batched`` where the runtime has the batched entry point
and ``loop`` otherwise (the per-page reference engine).  The two drivers
are bit-exact against each other: spans serialize through their grant
chain either way, so the op order is the same whichever driver runs the
bulk part.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.config import DRIVERS, check_choice


def _phase_callable(rt, driver: str):
    if driver == "batched":
        batched = getattr(rt, "phase_all", None)
        if batched is None:
            raise ValueError(
                "session(driver='batched'): runtime has no phase_all "
                "(use driver='loop' for the reference engine)")
        return batched
    W = rt.W
    per_worker = getattr(rt, "phase", None)

    def at(v, w):
        return float(v[w]) if np.ndim(v) else float(v)

    def loop(reads=(), writes=(), *, flops=0.0, mem_bytes=0.0, seconds=0.0,
             instr_words=0.0):
        for w in range(W):
            r = [(ga, int(lo[w]), int(hi[w])) for ga, lo, hi in reads]
            wr = [(ga, int(lo[w]), int(hi[w])) for ga, lo, hi in writes]
            fl, mb = at(flops, w), at(mem_bytes, w)
            sec, iw = at(seconds, w), at(instr_words, w)
            if per_worker is not None:
                per_worker(w, reads=r, writes=wr, flops=fl, mem_bytes=mb,
                           seconds=sec, instr_words=iw)
                continue
            for ga, lo, hi in r:
                rt.read(w, ga, lo, hi)
            for ga, lo, hi in wr:
                rt.write(w, ga, lo, hi)
            if fl or mb or sec:
                rt.compute(w, flops=fl, mem_bytes=mb, seconds=sec)
            if iw:
                rt.instr_stores(w, iw)
    return loop


def _span_callable(rt, driver: str):
    if driver == "batched":
        batched = getattr(rt, "span_all", None)
        if batched is None:
            raise ValueError(
                "session(driver='batched'): runtime has no span_all "
                "(use driver='loop' for the reference engine)")

        def span_batched(lock_ids, reads=(), writes=(), w_mask=None):
            batched(w_mask, lock_ids, reads=reads, writes=writes)
        return span_batched
    W = rt.W

    def span_loop(lock_ids, reads=(), writes=(), w_mask=None):
        locks = np.broadcast_to(np.asarray(lock_ids, np.int64), (W,))
        for w in range(W):
            if w_mask is not None and not w_mask[w]:
                continue
            rt.acquire(w, int(locks[w]))
            for ga, lo, hi in reads:
                rt.read(w, ga, int(lo[w]), int(hi[w]))
            for ga, lo, hi in writes:
                rt.write(w, ga, int(lo[w]), int(hi[w]))
            rt.release(w, int(locks[w]))
    return span_loop


class Session:
    """Named phase/span/reduce drivers bound to one runtime.

    ``driver`` is resolved once at construction (``auto`` picks
    ``batched`` iff the runtime has ``phase_all``); the resolved name is
    ``s.driver``."""

    def __init__(self, rt, driver: str = "auto"):
        check_choice("driver", driver, DRIVERS)
        self.rt = rt
        if driver == "auto":
            driver = ("batched" if getattr(rt, "phase_all", None) is not None
                      else "loop")
        self.driver = driver
        self.phase = _phase_callable(rt, driver)
        self.span = _span_callable(rt, driver)

    def reduce(self, name: str, value: float = 1.0):
        """Per-worker reduction contribution: one ``reduce_all`` call where
        the runtime has it, else ``rt.reduce`` per worker (the same combine
        and traffic either way)."""
        reduce_all = getattr(self.rt, "reduce_all", None)
        if reduce_all is not None:
            reduce_all(name, value)
        else:
            for w in range(self.rt.W):
                self.rt.reduce(w, name, value)

    def barrier(self):
        self.rt.barrier()


def session(rt, driver: str = "auto") -> Session:
    """Factory spelling of :class:`Session` (the public entry point)."""
    return Session(rt, driver)
