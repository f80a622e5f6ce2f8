"""Input pipeline: source -> device batches with double-buffered prefetch
(the port of the reference's ``data/pipeline.py``).

The prefetcher assembles the host batches of steps s+1..s+depth on a
background thread while the device runs step s.  Only numpy runs on that
thread: ``put_fn``, which turns a batch into tensors on the device, runs
in ``__next__`` on the caller's thread, so no CUDA call is made from the
prefetch thread.  ``Prefetcher.at(step)`` keeps the stateless-by-step
contract of the sources, so restart and elastic jumps are ``at(s0)``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.config import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "synthetic"          # 'synthetic' | 'memmap'
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    path: Optional[str] = None       # memmap corpus file

    def make_source(self):
        from repro_torch.data.sources import MemmapTokens, SyntheticTokens
        if self.kind == "synthetic":
            return SyntheticTokens(self.vocab_size, self.seq_len,
                                   self.global_batch, self.seed)
        if self.kind == "memmap":
            return MemmapTokens(Path(self.path), self.seq_len,
                                self.global_batch)
        raise ValueError(self.kind)


class Prefetcher:
    """Double-buffered background prefetch over a stateless-by-step source."""

    def __init__(self, source, *, start_step: int = 0, depth: int = 2,
                 rank: int = 0, world: int = 1,
                 put_fn: Optional[Callable] = None):
        self.source = source
        self.depth = depth
        self.rank, self.world = rank, world
        self.put_fn = put_fn or (lambda b: b)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._lock = threading.Lock()
        self._gen = 0
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                step, gen = self._next, self._gen
                self._next += 1
            batch = self.source.batch_at(step, rank=self.rank,
                                         world=self.world)
            while not self._stop.is_set():
                try:
                    self._q.put((gen, step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def at(self, step: int):
        """Jump the stream (restart / elastic rescale): drop queued batches
        from the old position and resume at ``step``."""
        with self._lock:
            self._gen += 1
            self._next = step
        while True:          # drain stale entries
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        return self

    def __next__(self):
        while True:
            gen, step, batch = self._q.get()
            with self._lock:
                if gen == self._gen:
                    break
            # stale generation: discard
        return step, self.put_fn(batch)

    def close(self):
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


def make_pipeline(cfg: DataConfig, *, start_step: int = 0, rank: int = 0,
                  world: int = 1, device="cuda") -> Prefetcher:
    """Prefetcher whose ``put_fn`` places the host batches on ``device``
    (the card unless the CPU is asked for; raises without a card)."""
    dev = resolve_device(device)

    def put(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}
    return Prefetcher(cfg.make_source(), start_step=start_step, rank=rank,
                      world=world, put_fn=put)
