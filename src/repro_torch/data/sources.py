"""Token sources: deterministic synthetic stream + memmap-backed corpus
(the port's own copy of the reference's numpy-only ``data/sources.py``:
the streams are the reference's bit for bit).

Both are *stateless by step index*: ``batch_at(step)`` is a pure function of
(seed, step, rank layout), which is what makes checkpoint/restart and elastic
rescale exact — a restarted (or resharded) job replays the identical token
stream from any step without persisting reader state (only the step counter
lives in the checkpoint).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)


def _hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — cheap stateless per-element PRNG."""
    x = (x + _MIX) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(31)
    return x


@dataclasses.dataclass
class SyntheticTokens:
    """Deterministic pseudo-random tokens with a learnable bigram structure
    (next token correlates with current), so tiny models can overfit it and
    integration tests can assert loss decreases."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, *, rank: int = 0, world: int = 1
                 ) -> dict:
        assert self.global_batch % world == 0, (self.global_batch, world)
        b_local = self.global_batch // world
        rows = (np.arange(b_local, dtype=np.uint64)
                + np.uint64(rank * b_local)
                + np.uint64(step) * np.uint64(self.global_batch))
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)
        # base stream
        h = _hash64(rows[:, None] * np.uint64(1_000_003) + cols[None, :]
                    + np.uint64(self.seed) * np.uint64(7_919))
        toks = (h % np.uint64(self.vocab_size)).astype(np.int64)
        # bigram structure: with p~0.75, next = f(current) (deterministic map)
        gate = (_hash64(h) % np.uint64(4)) != 0
        mapped = (toks * 31 + 7) % self.vocab_size
        for t in range(1, self.seq_len + 1):
            toks[:, t] = np.where(gate[:, t], mapped[:, t - 1], toks[:, t])
            mapped[:, t] = (toks[:, t] * 31 + 7) % self.vocab_size
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def write_token_file(path: Path, tokens: np.ndarray):
    """uint32 raw token file + .meta sidecar (the on-disk corpus format)."""
    path = Path(path)
    tokens = np.asarray(tokens, np.uint32)
    tmp = path.with_suffix(".tmp")
    tokens.tofile(tmp)
    tmp.rename(path)
    path.with_suffix(path.suffix + ".meta").write_text(
        f"{{\"n_tokens\": {tokens.size}, \"dtype\": \"uint32\"}}\n")


@dataclasses.dataclass
class MemmapTokens:
    """Memmap-backed corpus, sequence-packed, strided per-rank sharding.

    Sample i of step s is the window starting at
    ``(s * global_batch + i) * seq_len  mod  usable`` — contiguous packing,
    wrapping at the end of the corpus (standard LM packing).
    """

    path: Path
    seq_len: int
    global_batch: int

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=np.uint32, mode="r")
        self.n_tokens = int(self._mm.shape[0])
        assert self.n_tokens > self.seq_len + 1, "corpus smaller than one window"

    @property
    def n_windows(self) -> int:
        return (self.n_tokens - 1) // self.seq_len

    def batch_at(self, step: int, *, rank: int = 0, world: int = 1) -> dict:
        assert self.global_batch % world == 0
        b_local = self.global_batch // world
        idx = (np.arange(b_local, dtype=np.int64) + rank * b_local
               + np.int64(step) * self.global_batch) % self.n_windows
        starts = idx * self.seq_len
        out = np.empty((b_local, self.seq_len + 1), np.int64)
        for j, st in enumerate(starts):          # windows may wrap
            seg = np.asarray(self._mm[st: st + self.seq_len + 1])
            if seg.shape[0] < self.seq_len + 1:
                seg = np.concatenate(
                    [seg, self._mm[: self.seq_len + 1 - seg.shape[0]]])
            out[j] = seg
        out = out.astype(np.int32)
        return {"tokens": out[:, :-1], "targets": out[:, 1:]}
