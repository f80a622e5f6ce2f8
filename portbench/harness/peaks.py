"""The table of peaks the shares are taken against: one NVIDIA H100 SXM,
NVIDIA's data sheet, dense rates at the full 700 W.

float32 is taken at 165 TFLOP/s: three TF32 tensor-core products at 495
TFLOP/s make one float32-accurate product (split TF32, which the port's
attention and SSD kernels already use).  That is the fastest way this
card delivers float32 accuracy, so no honest change of a float32 path
can read above 100% of it; 67 TFLOP/s, the CUDA cores' float32 rate,
would be passed as soon as a GEMM moved to split TF32.
"""
from __future__ import annotations

FLOPS_PER_S = {
    "float32": 165e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}
HBM_BYTES_PER_S = 3.35e12


def flops_per_s(dtype) -> float:
    return FLOPS_PER_S[str(dtype).replace("torch.", "")]
