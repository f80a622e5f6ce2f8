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

The wrapper checks its operands, allocates the output with ``torch.empty``
and launches on the current stream, adding one to ``LAUNCHES[name]`` per
launch and to ``CALLS[name]`` per call on any device.  A tensor on the
CPU takes the plain PyTorch version (``flash_attention_plain``, the
materialised softmax of the reference's oracle); a CUDA tensor gets the
kernel or an exception, never the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import Kernels, on_card

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y = 65535            # query tiles of 64 rows on the grid's y axis

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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The reference oracle (``ref.flash_attention_ref``): the KV heads
    repeated, the (S, S) scores materialised in float32, a full softmax."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    s = torch.matmul(q.float(), kr.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vr).to(q.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype."""
    _KERNELS.called("flash_attention")
    _check(q, k, v, window, softcap)
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
