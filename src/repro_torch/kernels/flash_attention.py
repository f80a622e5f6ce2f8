"""Causal GQA flash attention of the model path's prefill.

Hand-written CUDA kernel (``csrc/flash_attention.cu``, ``sm_90a``), the
counterpart of the reference's Pallas ``flash_attention``:

* ``flash_attention(q, k, v, *, scale=None, causal=True, window=None,
  softcap=None)``: q (B, Hq, S, D), k and v (B, Hkv, S, D) -> (B, Hq, S,
  D) in q's dtype.  Query head h reads KV head h // (Hq // Hkv), with no
  KV repeat in memory; ``scale`` defaults to D ** -0.5; ``window`` keeps
  keys with q_pos - k_pos < window; ``softcap`` applies softcap *
  tanh(s / softcap) to the scaled scores before the mask.

float32 or bfloat16 operands, float32 accumulation; any S >= 1 and
D in {16, 32, 64, 128}.  The operands may be strided views as long as the
last dimension is contiguous, so the model passes its (B, S, H, D)
activations transposed without a copy; the result is a (B, Hq, S, D) view
of a tensor laid out (B, S, Hq, D), the model's layout.

The kernel runs both products on the tensor cores: bfloat16 as bf16
``mma.sync`` with p taken as two bf16 terms in P.V; float32 as three
split-TF32 products, which keep float32 accuracy with TF32 off.
``flash_attention_tf32_products`` and ``flash_attention_bf16_products``
model that arithmetic in plain torch for the CPU tests.

The wrapper checks its operands, allocates the output with ``torch.empty``
and launches on the current stream, adding one to ``LAUNCHES[name]`` per
launch and to ``CALLS[name]`` per call on any device.  A tensor on the
CPU takes the plain PyTorch version (``flash_attention_plain``, the
materialised softmax of the reference's oracle); a CUDA tensor gets the
kernel or an exception, never the plain version.

The wrapper is differentiable through ``FlashAttention``, an autograd
Function whose forward is the above and whose backward recomputes the
plain version under autograd from the saved q, k and v
(``flash_attention_plain_grads``), in blocks of ``BWD_QUERY_ROWS`` query
rows so that the recompute never holds the whole (B, Hq, S, S) scores.
There is no backward kernel: the reference differentiates XLA's
``blocked_attention``, not its Pallas kernel.  Under remat the forward,
kernel launch included, runs again before the backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import Kernels, on_card
from repro_torch.kernels._tf32 import _mm_tf32

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y = 65535            # query tiles of 64 rows on the grid's y axis
# keys of the kernel's KV tile in each dtype
KEY_TILE = {torch.float32: 32, torch.bfloat16: 64}
# query rows a block of the backward's plain recompute
BWD_QUERY_ROWS = 1024

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_KERNELS = Kernels("flash_attention.cu", {
    "flash_attention": (_P, _P, _P, _P, _I) + (_L,) * 17 + (_F, _I, _I, _F),
})
# launch counter, bumped only where the kernel launches; CALLS counts the
# wrapper's calls on any device
LAUNCHES = _KERNELS.launches
CALLS = _KERNELS.calls
reset_launches = _KERNELS.reset


def _attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q0: int, scale: Optional[float], causal: bool,
                    window: Optional[int], softcap: Optional[float]
                    ) -> torch.Tensor:
    """The plain version for the query rows q0, q0 + 1, ... that ``q``
    holds, against every key of ``k`` and ``v`` (positions from 0)."""
    B, Hq, Sq, D = q.shape
    S = k.shape[2]
    G = Hq // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    s = torch.matmul(q.float(), kr.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q0, q0 + Sq, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((Sq, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vr).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The reference oracle (``ref.flash_attention_ref``): the KV heads
    repeated, the (S, S) scores materialised in float32, a full softmax."""
    return _attention_rows(q, k, v, 0, scale, causal, window, softcap)


def flash_attention_plain_grads(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, grad: torch.Tensor, *,
                                scale: Optional[float] = None,
                                causal: bool = True,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                rows: int = BWD_QUERY_ROWS):
    """(dq, dk, dv): the plain version's gradients for the output
    gradient ``grad``, recomputed under autograd from the inputs, in
    blocks of ``rows`` query rows, each against the keys it can see (the
    keys before the block's end when causal).  A block's (B, Hq, rows,
    keys) float32 scores are what the recompute holds at once, in place
    of the whole (B, Hq, S, S).  k and v enter in float32, so the blocks'
    dk and dv (and a GQA group's heads) add in float32: in float32 and at
    one block (S <= rows) this is the plain version's autograd as it
    stands; in bfloat16 every gradient is the float32 one rounded once
    to bfloat16 (autograd of the bfloat16 plain version would round a
    group's terms before adding them)."""
    S = q.shape[2]
    with torch.enable_grad():
        # the blocks' dk and dv add in float32, rounded once to k's dtype
        kk = k.detach().float().requires_grad_(True)
        vv = v.detach().float().requires_grad_(True)
        dq, dk, dv = [], None, None
        for a in range(0, S, rows):
            b = min(S, a + rows)
            end = b if causal else S
            qb = q[:, :, a:b].detach().requires_grad_(True)
            out = _attention_rows(qb, kk[:, :, :end], vv[:, :, :end], a,
                                  scale, causal, window, softcap)
            gq, gk, gv = torch.autograd.grad(out, (qb, kk, vv),
                                             grad[:, :, a:b])
            dq.append(gq)
            dk = gk if dk is None else dk + gk
            dv = gv if dv is None else dv + gv
    return (torch.cat(dq, dim=2) if len(dq) > 1 else dq[0], dk.to(k.dtype),
            dv.to(v.dtype))


def _tiled(q, k, v, scale, causal, window, softcap, qk, pv):
    """The kernel's online softmax over key tiles of ``KEY_TILE[q.dtype]``:
    the scores of a tile from ``qk(q, k^T)``, scaled, softcapped and
    masked in the reference's order, the running max and sum, and
    ``pv(p, v)`` added to the rescaled accumulator; the final divide by
    max(l, 1e-30)."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    qf = q.float()
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    pos = torch.arange(S, device=q.device)
    m = torch.full((B, Hq, S, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, S, 1), device=q.device)
    acc = torch.zeros((B, Hq, S, D), device=q.device)
    tile = KEY_TILE[q.dtype]
    for k0 in range(0, S, tile):
        keys = slice(k0, k0 + tile)
        s = qk(qf, kr[:, :, keys].transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kp = pos[keys]
        mask = torch.ones((S, kp.numel()), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= pos[:, None] >= kp[None, :]
        if window is not None:
            mask &= pos[:, None] - kp[None, :] < window
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + pv(p, vr[:, :, keys])
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def flash_attention_tf32_products(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *,
                                  scale: Optional[float] = None,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None,
                                  products: int = 3) -> torch.Tensor:
    """A model of the float32 kernel's arithmetic: the online softmax over
    32-key tiles with q.k^T and p.v each taken on TF32 operands,
    ``products=3`` the kernel's split (hi*hi + hi*lo + lo*hi, float32
    accuracy), ``products=1`` a single TF32 product.  Each product's sums
    are exact (float64) and rounded once, so the error left is the
    operands' rounding, which is what the split removes."""
    def mm(a, b):
        return _mm_tf32(a, b, products)
    return _tiled(q, k, v, scale, causal, window, softcap, mm, mm)


def flash_attention_bf16_products(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *,
                                  scale: Optional[float] = None,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None,
                                  p_terms: int = 2) -> torch.Tensor:
    """A model of the bfloat16 kernel's arithmetic: the online softmax
    over 64-key tiles, q.k^T of the bfloat16 operands with exact sums, and
    p in bfloat16 for p.v while the row sums take the unrounded p:
    ``p_terms=2`` the kernel's two terms, hi = bf16(p) and lo = bf16(p -
    hi); ``p_terms=1`` p rounded once, as the reference's Pallas kernel
    does (``p.astype(v.dtype)``).  The result is rounded once to
    bfloat16."""
    def exact(a, b):
        return torch.matmul(a.double(), b.double()).float()

    def pv(p, vv):
        hi = p.to(torch.bfloat16).float()
        out = exact(hi, vv)
        if p_terms == 2:
            out = out + exact((p - hi).to(torch.bfloat16).float(), vv)
        return out
    return _tiled(q, k, v, scale, causal, window, softcap, exact, pv)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: Optional[float]):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, H, S, D), got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")


def _forward(q, k, v, scale, causal, window, softcap) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on the CPU."""
    if not on_card(q):
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap)
    B, Hq, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if -(-S // 64) > _GRID_Y or B * Hq >= 1 << 31:
        raise ValueError(f"flash_attention: (B*Hq, S)=({B * Hq}, {S}) "
                         "exceeds the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel():
        strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
        _KERNELS.launch(
            "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, Hq, k.shape[1], S, D, *strides,
            D ** -0.5 if scale is None else float(scale), int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap))
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward: the
    plain version's gradients, recomputed under autograd from the saved
    inputs (``flash_attention_plain_grads``); no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap)
        return _forward(q, k, v, scale, causal, window, softcap)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_plain_grads(q, k, v, grad, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype;
    differentiable (``FlashAttention``)."""
    _KERNELS.called("flash_attention")
    _check(q, k, v, window, softcap)
    return FlashAttention.apply(q, k, v, scale, causal, window, softcap)
