"""Frozen counts of the operations and bytes a kernel's call needs,
from the shapes of its operands, for the roofline shares.

A count is what the algorithm needs, whatever the kernel does: each
input read once, each output written once, and the products of the
unmasked pairs only.  Each function takes the call's arguments as the
program's wrapper takes them and returns ``(flops, bytes, dtype)``; the
flops go over the dtype's peak (``peaks``), the bytes over HBM's.
"""
from __future__ import annotations

from . import peaks


def causal_pairs(S: int, window=None) -> int:
    """Unmasked (query, key) pairs of a causal mask over S positions,
    keys within ``window`` of the query when one is given."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    w = int(window)
    return w * (w + 1) // 2 + (S - w) * w


def flash_attention_work(q, k, v, *, scale=None, causal=True, window=None,
                         softcap=None):
    """q (B, Hq, S, D), k and v (B, Hkv, S, D): 4 D flops per unmasked
    pair (q.k and p.v; the softmax's few operations a pair are not
    counted) in each of the B Hq heads; q, k, v read and the output
    written once."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    pairs = causal_pairs(S, window) if causal else S * S
    item = q.element_size()
    return (4 * D * pairs * B * Hq,
            item * (2 * B * Hq * S * D + 2 * B * Hkv * S * D), q.dtype)


def ssd_chunk_work(x, dt, cum, B_, C_):
    """x (M, Q, P), dt and cum (M, Q, 1), B_ and C_ (Mg, Q, N): C.B^T
    over the Q(Q+1)/2 causal pairs (2N flops each) once per B/C row,
    which the M // Mg cells of a group share; per cell the scores times
    x (2P a pair) and the (P, N) state over Q rows (2PN each).  x, B and
    C read once, dt and cum in float32, y and the state written once in
    float32."""
    M, Q, P = x.shape
    Mg, _, N = B_.shape
    pairs = Q * (Q + 1) // 2
    flops = Mg * pairs * 2 * N + M * (pairs * 2 * P + 2 * Q * P * N)
    item = x.element_size()
    nbytes = (item * (M * Q * P + 2 * Mg * Q * N)
              + 4 * (2 * M * Q + M * Q * P + M * P * N))
    return flops, nbytes, x.dtype


def least_seconds(flops: float, nbytes: float, dtype) -> float:
    """The least time the card could take: the larger of the operations
    at the dtype's peak and the bytes at HBM's bandwidth."""
    return max(flops / peaks.flops_per_s(dtype),
               nbytes / peaks.HBM_BYTES_PER_S)
