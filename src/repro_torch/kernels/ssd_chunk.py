"""Mamba-2 SSD intra-chunk block of the model path's prefill.

Hand-written CUDA kernel (``csrc/ssd_chunk.cu``, ``sm_90a``), the
counterpart of the reference's Pallas ``ssd_chunk``.  For each of M cells
(batch row, chunk, head) with chunk length Q, head dim P, state dim N:

* ``ssd_chunk(x, dt, cum, B_, C_)`` -> (y (M, Q, P), state (M, P, N)),
  both float32, where
  y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j and
  state = sum_j exp(cum_{Q-1} - cum_j) dt_j (x_j outer B_j).

x is (M, Q, P); dt and cum are (M, Q, 1); B_ and C_ are (Mg, Q, N) with
Mg dividing M: cell m reads row m // (M // Mg), so B/C groups shared by
consecutive heads are passed once per group (Mg = M is the reference's
per-cell layout).  x, B_ and C_ are float32 or bfloat16 (one dtype);
dt and cum float32 or that dtype (bfloat16 is widened exactly before the
launch).  Any Q >= 1; P and N in {16, 32, 64, 128}.

The kernel forms C.B^T once per (B/C row, 64-row query stripe, slice of
the row's heads) and runs every product on the tensor cores as three
TF32 products of split operands (hi*hi + hi*lo + lo*hi, f32
accumulation), which keeps f32 accuracy with TF32 off
(``ssd_chunk_tf32_products`` emulates that arithmetic in plain torch).

The wrapper checks its operands, allocates the outputs with
``torch.empty`` and launches on the current stream, adding one to
``LAUNCHES[name]`` per launch and to ``CALLS[name]`` per call on any
device.  A tensor on the CPU takes the plain PyTorch version
(``ssd_chunk_plain``, the reference's oracle); a CUDA tensor gets the
kernel or an exception, never the plain version.

The wrapper is differentiable through ``SSDChunk``, an autograd Function
whose forward is the above and whose backward recomputes
``ssd_chunk_plain`` under autograd from the saved inputs.  There is no
backward kernel: the reference differentiates its jnp ``ssd_chunked``,
not its Pallas kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import Kernels, on_card
from repro_torch.kernels._tf32 import _mm_tf32

DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_KERNELS = Kernels("ssd_chunk.cu", {
    "ssd_chunk": (_P,) * 7 + (ctypes.c_int,) + (_L,) * 5,
})
# launch counter, bumped only where the kernel launches; CALLS counts the
# wrapper's calls on any device
LAUNCHES = _KERNELS.launches
CALLS = _KERNELS.calls
reset_launches = _KERNELS.reset


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    B_: torch.Tensor, C_: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference oracle (``ref.ssd_chunk_ref``) on the per-cell
    layout: grouped B/C rows are repeated to one per cell first."""
    rep = x.shape[0] // B_.shape[0]
    xf = x.float()
    dtf = dt[..., 0].float()                    # (M, Q)
    cumf = cum[..., 0].float()
    Bf = B_.float().repeat_interleave(rep, dim=0)
    Cf = C_.float().repeat_interleave(rep, dim=0)
    Q = x.shape[1]
    cb = torch.matmul(Cf, Bf.transpose(1, 2))   # (M, Q, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    delta = torch.where(causal, cumf[:, :, None] - cumf[:, None, :],
                        torch.full((), -torch.inf, device=x.device))
    scores = cb * torch.exp(delta) * dtf[:, None, :]   # mask before exp
    y = torch.matmul(scores, xf)
    w_in = torch.exp(cumf[:, -1:] - cumf) * dtf        # (M, Q)
    state = torch.einsum("mq,mqp,mqn->mpn", w_in, xf, Bf)
    return y, state


def ssd_chunk_tf32_products(x: torch.Tensor, dt: torch.Tensor,
                            cum: torch.Tensor, B_: torch.Tensor,
                            C_: torch.Tensor, products: int = 3
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunk_plain`` with each of its three products (C.B^T, scores
    times x, the state) taken on TF32 operands: ``products=3`` is the
    kernel's split (f32 accuracy), ``products=1`` a single TF32 product.
    Each product's sums are exact (float64) and rounded once, so the
    error left is the operands' rounding, which is what the split
    removes.  A model of the kernel's arithmetic for the CPU tests."""
    rep = x.shape[0] // B_.shape[0]
    xf = x.float()
    dtf = dt[..., 0].float()
    cumf = cum[..., 0].float()
    Bf = B_.float().repeat_interleave(rep, dim=0)
    Cf = C_.float().repeat_interleave(rep, dim=0)
    Q = x.shape[1]
    cb = _mm_tf32(Cf, Bf.transpose(1, 2), products)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    delta = torch.where(causal, cumf[:, :, None] - cumf[:, None, :],
                        torch.full((), -torch.inf, device=x.device))
    scores = cb * torch.exp(delta) * dtf[:, None, :]
    y = _mm_tf32(scores, xf, products)
    w_in = torch.exp(cumf[:, -1:] - cumf) * dtf
    state = _mm_tf32((xf * w_in[..., None]).transpose(1, 2), Bf, products)
    return y, state


def _check(x, dt, cum, B_, C_):
    if x.dim() != 3:
        raise ValueError(f"x must be 3-D (M, Q, P), got {tuple(x.shape)}")
    M, Q, P = x.shape
    if Q < 1:
        raise ValueError(f"ssd_chunk needs a chunk length Q >= 1, got {Q}")
    for name, t in (("x", x), ("B_", B_), ("C_", C_)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("cum", cum)):
        if t.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{name} must be float32 or {x.dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != (M, Q, 1):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(M, Q, 1)}")
    if B_.dim() != 3 or B_.shape != C_.shape or B_.shape[1] != Q:
        raise ValueError(f"B_ {tuple(B_.shape)} and C_ {tuple(C_.shape)} "
                         f"must be (Mg, {Q}, N)")
    if B_.shape[0] < 1 or M % B_.shape[0]:
        raise ValueError(f"B_/C_ rows {B_.shape[0]} do not divide M={M}")
    for name, t in (("x", x), ("dt", dt), ("cum", cum), ("B_", B_),
                    ("C_", C_)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _forward(x, dt, cum, B_, C_):
    """The kernel on a CUDA tensor, the plain version on the CPU."""
    if not on_card(x):
        return ssd_chunk_plain(x, dt, cum, B_, C_)
    M, Q, P = x.shape
    N = B_.shape[2]
    if P not in DIMS or N not in DIMS:
        raise ValueError(f"ssd_chunk: P={P}, N={N} not in {DIMS}")
    if M >= 1 << 31 or Q >= 1 << 31:
        raise ValueError(f"ssd_chunk: (M, Q)=({M}, {Q}) exceeds the grid")
    # the kernel copies x, B and C in 16-byte pieces (cp.async)
    x, B_, C_ = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (x, B_, C_))
    dt = dt.float().contiguous()
    cum = cum.float().contiguous()
    y = torch.empty((M, Q, P), dtype=torch.float32, device=x.device)
    state = torch.empty((M, P, N), dtype=torch.float32, device=x.device)
    if M:
        _KERNELS.launch("ssd_chunk", x.device, x.data_ptr(), dt.data_ptr(),
                        cum.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                        y.data_ptr(), state.data_ptr(), DTYPES[x.dtype], M,
                        Q, P, N, M // B_.shape[0])
    return y, state


def ssd_chunk_plain_grads(inputs, grads):
    """The plain version's gradients for the output gradients ``grads``
    (of y and state), recomputed under autograd from ``inputs`` (x, dt,
    cum, B_, C_): one gradient an input."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = ssd_chunk_plain(*leaves)
        return torch.autograd.grad(outs, leaves, grads)


class SSDChunk(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward: the
    plain version's gradients, recomputed under autograd from the saved
    inputs (``ssd_chunk_plain_grads``); no backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, cum, B_, C_):
        ctx.save_for_backward(x, dt, cum, B_, C_)
        return _forward(x, dt, cum, B_, C_)

    @staticmethod
    def backward(ctx, gy, gstate):
        return ssd_chunk_plain_grads(ctx.saved_tensors, (gy, gstate))


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              B_: torch.Tensor, C_: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD: x (M, Q, P), dt/cum (M, Q, 1), B_/C_ (Mg, Q, N)
    -> y (M, Q, P) float32, state (M, P, N) float32; differentiable
    (``SSDChunk``)."""
    _KERNELS.called("ssd_chunk")
    _check(x, dt, cum, B_, C_)
    return SSDChunk.apply(x, dt, cum, B_, C_)
