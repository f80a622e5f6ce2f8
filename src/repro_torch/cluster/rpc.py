"""Control-plane <-> shard RPC over multiprocessing pipes.

One :class:`ShardChannel` per shard process, driven stop-and-wait by the
control plane (rounds are pipelined ACROSS shards by the caller: send to
every shard first, then collect).  The transport carries pickled
``(seq, op, payload)`` requests and ``(seq, status, data)`` replies.

Failure semantics — the whole point of this layer:

* **Deadlines + backoff.**  Every request waits ``timeout_s`` for its
  reply, re-sends, and waits ``timeout_s * backoff**k`` on attempt k.
  Retries are deduplicated shard-side by event/sequence number, so a
  re-send is always safe.  Exhausting ``attempts`` raises
  :class:`ShardDown` — the caller's failure detector.
* **Fast-path death.**  A SIGKILL'd shard closes its pipe; ``recv``
  raises ``EOFError`` and ``send`` raises ``BrokenPipeError``, both
  surfaced as :class:`ShardDown` immediately (no need to burn the full
  deadline chain on a corpse).
* **Partitions.**  ``drop_c2s`` silently discards control->shard sends
  (the shard never hears the request); ``drop_s2c`` discards
  shard->control replies as they arrive (the shard DID the work, but the
  control plane cannot know).  Either direction alone must drive the
  deadline chain to :class:`ShardDown` — that asymmetry is what the
  recovery tests exercise.

Real wall-clock retry time is not charged to the modeled runtime clocks
(that would break bit-equality with the single-process run); the control
plane accounts it separately through ``ChaosNet.backoff_seconds`` — the
same capped-exponent term the in-model message-loss tier charges.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple


class ShardDown(RuntimeError):
    """A shard stopped answering: dead pipe or exhausted deadline chain."""

    def __init__(self, rank: int, reason: str):
        super().__init__(f"shard {rank} down ({reason})")
        self.rank = rank
        self.reason = reason


class ShardError(RuntimeError):
    """The shard executed the request and raised — a programming error
    propagated verbatim, NOT a failure-detection event."""

    def __init__(self, rank: int, traceback_text: str):
        super().__init__(f"shard {rank} raised:\n{traceback_text}")
        self.rank = rank


class ShardChannel:
    """One control-plane endpoint: seq-numbered requests with deadlines,
    re-sends, partition injection, and dead-pipe detection."""

    def __init__(self, conn, rank: int):
        self.conn = conn
        self.rank = rank
        self.drop_c2s = False     # partition: control -> shard direction
        self.drop_s2c = False     # partition: shard -> control direction
        self._seq = 0

    # -- transport ------------------------------------------------------
    def _send(self, seq: int, op: str, payload: Any):
        if self.drop_c2s:
            return                # the partition eats the request
        try:
            self.conn.send((seq, op, payload))
        except (BrokenPipeError, ConnectionResetError, OSError):
            raise ShardDown(self.rank, "pipe closed on send")

    def _recv_until(self, seq: int, timeout_s: float
                    ) -> Optional[Tuple[str, Any]]:
        """Reply for ``seq`` within ``timeout_s``, or None on deadline.
        Stale replies (earlier attempts / earlier requests) are skipped;
        an s2c partition discards replies as if they were never sent."""
        end = time.monotonic() + timeout_s
        while True:
            remaining = end - time.monotonic()
            if remaining <= 0:
                return None
            try:
                if not self.conn.poll(remaining):
                    return None
                msg = self.conn.recv()
            except (EOFError, ConnectionResetError, OSError):
                raise ShardDown(self.rank, "pipe closed on recv")
            if self.drop_s2c:
                continue          # the partition eats the reply
            mseq, status, data = msg
            if mseq != seq:
                continue          # stale duplicate from a prior attempt
            return status, data

    # -- request API ----------------------------------------------------
    def start(self, op: str, payload: Any) -> Tuple[int, str, Any]:
        """Send attempt 0 and return a token for :meth:`finish` — the
        split lets the control plane broadcast a round to every shard
        before it starts collecting."""
        self._seq += 1
        self._send(self._seq, op, payload)
        return (self._seq, op, payload)

    def finish(self, token: Tuple[int, str, Any], *, timeout_s: float,
               attempts: int, backoff: float,
               on_retry: Optional[Callable[[int], None]] = None
               ) -> Tuple[Any, int]:
        """Collect the reply for ``token``; returns ``(data, retries)``
        where ``retries`` is the number of deadline levels burned.  Each
        timeout re-sends the request (shard-side dedup makes that safe)
        and widens the next deadline by ``backoff``."""
        seq, op, payload = token
        for k in range(attempts):
            reply = self._recv_until(seq, timeout_s * (backoff ** k))
            if reply is not None:
                status, data = reply
                if status == "err":
                    raise ShardError(self.rank, data)
                return data, k
            if on_retry is not None:
                on_retry(k)
            if k + 1 < attempts:
                self._send(seq, op, payload)
        raise ShardDown(self.rank, f"deadline after {attempts} attempts")

    def request(self, op: str, payload: Any, *, timeout_s: float,
                attempts: int = 1, backoff: float = 2.0,
                on_retry: Optional[Callable[[int], None]] = None
                ) -> Tuple[Any, int]:
        return self.finish(self.start(op, payload), timeout_s=timeout_s,
                           attempts=attempts, backoff=backoff,
                           on_retry=on_retry)

    def close(self):
        try:
            self.conn.close()
        except OSError:
            pass
