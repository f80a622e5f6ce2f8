"""The frozen counts of kernel work and model FLOPs against hand counts,
and the attention bound against PERF.md's kernel table (833.17 µs for
flash_attention at (2, 16, 8, 4096, 128) float32)."""
from __future__ import annotations

import pytest
import torch

from portbench.harness import kernel_work as kw
from portbench.harness import peaks


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_flash_attention_train_shape_bound():
    B, Hq, Hkv, S, D = 2, 16, 8, 4096, 128
    flops, nbytes, dt = kw.flash_attention_work(
        meta(B, Hq, S, D), meta(B, Hkv, S, D), meta(B, Hkv, S, D))
    assert flops == 4 * D * (S * (S + 1) // 2) * B * Hq
    assert nbytes == 4 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    assert round(flops / 165e12 * 1e6, 2) == 833.17
    assert round(nbytes / 3.35e12 * 1e6, 2) == 60.10
    assert kw.least_seconds(flops, nbytes, dt) == flops / 165e12


def test_flash_attention_bf16_and_window():
    q = meta(1, 2, 10, 16, dtype=torch.bfloat16)
    k = meta(1, 1, 10, 16, dtype=torch.bfloat16)
    flops, nbytes, dt = kw.flash_attention_work(q, k, k, window=3)
    # pairs with 0 <= i - j < 3 over 10 positions: 1 + 2 + 3 * 8
    assert kw.causal_pairs(10, 3) == 27
    assert flops == 4 * 16 * 27 * 2
    assert nbytes == 2 * (2 * 2 * 10 * 16 + 2 * 1 * 10 * 16)
    assert peaks.flops_per_s(dt) == 989e12


def test_causal_pairs_by_enumeration():
    for S in (1, 2, 7, 33):
        for w in (None, 1, 4, 40):
            want = sum(1 for i in range(S) for j in range(S)
                       if j <= i and (w is None or i - j < w))
            assert kw.causal_pairs(S, w) == want


def test_ssd_chunk_hand_count():
    M, Q, P, N, rep = 6, 4, 2, 3, 3
    flops, nbytes, _ = kw.ssd_chunk_work(
        meta(M, Q, P), meta(M, Q, 1), meta(M, Q, 1), meta(M // rep, Q, N),
        meta(M // rep, Q, N))
    pairs = 10                        # 4 * 5 / 2
    assert flops == 2 * pairs * 2 * N + 6 * (pairs * 2 * P + 2 * Q * P * N)
    assert nbytes == 4 * (M * Q * P + 2 * 2 * Q * N) + 4 * (
        2 * M * Q + M * Q * P + M * P * N)


def test_dense_model_flops():
    from portbench.harness import bench
    fam = bench.cell("internlm2-train-4k").program()
    conf = bench.cell("internlm2-train-4k").config
    d, f, V, L = 2048, 8192, 92544, 24
    body = L * (d * (16 + 16) * 128 + 16 * 128 * d + 3 * d * f)
    step = 6 * (body + d * V) * 8192 + 6 * 4096 ** 2 * 2048 * L * 2
    assert fam.train_step_flops(conf, 2, 4096) == pytest.approx(step,
                                                                rel=1e-12)
    assert step == pytest.approx(9.352e13, rel=1e-3)
    n = 100
    assert fam.prefill_flops(conf, n) == pytest.approx(
        2 * body * n + 2 * n * n * 2048 * L + 2 * d * V)
    assert fam.decode_flops(conf, 7) == pytest.approx(
        2 * body + 4 * 7 * 2048 * L + 2 * d * V)


def test_mamba_ssd_flops_match_the_kernel_count():
    """A whole chunk's SSD FLOPs in the model count equal the kernel's
    count of one B/C row of the same shape."""
    from portbench.harness import bench
    cell = bench.cell("mamba2-serve-doc2k")
    fam, conf = cell.program(), cell.config
    H, P, N, Q = 80, 64, 128, 256
    flops, _, _ = kw.ssd_chunk_work(meta(H, Q, P), meta(H, Q, 1),
                                    meta(H, Q, 1), meta(1, Q, N),
                                    meta(1, Q, N))
    assert fam.ssd_flops(conf, Q) == flops
    # a second chunk adds its own work and C reading the carried state
    assert fam.ssd_flops(conf, 2 * Q) == 2 * flops + 2 * Q * H * P * N
    proj = 2560 * (2 * 5120 + 2 * 128 + 80) + 5120 * 2560
    assert fam.decode_flops(conf, 9) == pytest.approx(
        64 * (2 * proj + 4 * H * P * N) + 2 * 2560 * 50288)
