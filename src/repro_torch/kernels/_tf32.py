"""Plain-torch models of the kernels' split-TF32 arithmetic (see
``csrc/split_tf32.cuh``), for the CPU tests of ``ssd_chunk`` and
``flash_attention``: a float32 product taken on the tensor cores as
three TF32 products of split operands keeps float32 accuracy, one TF32
product does not."""
from __future__ import annotations

import torch


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``'s rounding, which the kernels' split
    takes for finite values."""
    b = t.contiguous().view(torch.int32).to(torch.int64)
    finite = (b & 0x7F800000) != 0x7F800000
    # int32 patterns sign-extended: the magnitude is rounded at bit 13
    r = torch.where(finite, (b + 0x1000) & ~0x1FFF, b)
    return r.to(torch.int32).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """``a @ b`` on TF32 operands, summed in float64 and rounded once to
    float32: one product of the rounded operands, or (``products`` = 3)
    the split hi*hi + hi*lo + lo*hi, hi = tf32(v) and lo = tf32(v - hi),
    as the kernels take it."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.matmul(ah.double(), bh.double()).float()
    if products == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = (torch.matmul(al.double(), bh.double())
               + torch.matmul(ah.double(), bl.double())).float() + out
    return out
