#!/usr/bin/env python3
"""The train path's attention backward on a CUDA card, recomputed in
query blocks or whole: what each costs in memory and time, alone and in
the train step.

    python3 train_probe.py [--steps N]

``flash_attention``'s autograd Function recomputes the plain version
under autograd in its backward (``flash_attention_plain_grads``: blocks
of ``BWD_QUERY_ROWS`` query rows, each against the keys before the
block's end, dk and dv added in float32).  The probe swaps in the whole
recompute, autograd of ``flash_attention_plain`` over every (query, key)
pair at once (one (B, Hq, S, S) float32 scores tensor and its
gradients), and measures both with TF32 off, as ``chip_smoke.py`` runs,
at its train phase's shape (internlm2-1.8b at full width and depth,
2 x 4096 tokens, remat "full", AdamW):

* the backward alone at one layer's shape (2, 16, 8, 4096, 128) in
  float32: its time (CUDA events over back-to-back calls) and the memory
  it allocates above its inputs; the two variants' gradients against
  each other, and the forward kernel against the plain version there;
* ``value_and_grad`` of the loss (forward and backward, no update): wall
  and peak memory, once a variant;
* the whole ``make_train_step`` step: wall and peak memory of N steps a
  turn, in turns blocks, whole, whole, blocks, after a first step that is
  not counted.

Prints the card line and then one JSON object, also written to
chiprun_out/train_probe.json.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (2, 16, 8, 4096, 128)        # (B, Hq, Hkv, S, D)


def whole_grads(q, k, v, grad, *, scale=None, causal=True, window=None,
                softcap=None):
    """(dq, dk, dv) by autograd of the plain version over every pair."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fa.flash_attention_plain(qq, kk, vv, scale=scale,
                                       causal=causal, window=window,
                                       softcap=softcap)
        return torch.autograd.grad(out, (qq, kk, vv), grad)


def peak_above(torch, fn):
    """(fn(), the most it allocated above what was allocated before)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def layer_backward(torch, np, smoke, fa, variants):
    rng = np.random.default_rng(0)
    q, k, v = smoke.flash_inputs(torch, np, rng, *SHAPE, torch.float32,
                                 "cuda")
    got, want = fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)
    row = {"shape": list(SHAPE),
           "forward_max_abs_err": float((got - want).abs().max())}
    del got, want
    grad = torch.as_tensor(rng.standard_normal(q.shape) * 0.1,
                           dtype=torch.float32, device="cuda")
    grads = {}
    for name, fn in variants.items():
        def call(fn=fn):
            return fn(q, k, v, grad)
        grads[name], extra = peak_above(torch, call)
        row[name] = {"bytes_above_inputs": extra,
                     "ms": smoke.timed_ms(torch, call, 3, 3)}
    row["max_abs_diff_dq_dk_dv"] = [float((a - b).abs().max()) for a, b in
                                    zip(grads["blocks"], grads["whole"])]
    return row


def train_steps(torch, smoke, fa, variants, steps):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import model as M
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              make_train_step, value_and_grad)
    cfg = get_config(smoke.TRAIN_ARCH)
    hp = TrainHParams(lr=3e-4, warmup=2, total_steps=100, remat="full",
                      ce_chunk=1024)
    params, opt = init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    step_fn = make_train_step(cfg, hp)

    def loss_f(p, b):
        return M.loss_fn(cfg, p, b, attn_impl=hp.attn_impl, remat=hp.remat,
                         ce_chunk=hp.ce_chunk, remat_segment=hp.remat_segment)
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=smoke.TRAIN_SEQ,
                                    global_batch=smoke.TRAIN_BATCH),
                         device="cuda")
    rows = {name: {"step_s": [], "step_peak_bytes": []} for name in variants}
    try:
        step, batch = next(pipe)
        params, opt, _ = step_fn(params, opt, batch, step)     # not counted
        for name in ("blocks", "whole", "whole", "blocks"):
            fa.flash_attention_plain_grads = variants[name]
            r = rows[name]
            if "value_and_grad_s" not in r:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                (loss, _), grads = value_and_grad(loss_f, params, batch)
                float(loss)
                torch.cuda.synchronize()
                r["value_and_grad_s"] = time.perf_counter() - t0
                r["value_and_grad_peak_bytes"] = (
                    torch.cuda.max_memory_allocated())
                del grads
            for _ in range(steps):
                step, batch = next(pipe)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, batch, step)
                loss = float(m["loss"])
                r["step_s"].append(time.perf_counter() - t0)
                r["step_peak_bytes"].append(torch.cuda.max_memory_allocated())
                if loss != loss:
                    raise AssertionError(f"step {step}: loss {loss}")
    finally:
        pipe.close()
        fa.flash_attention_plain_grads = variants["blocks"]
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch":
            smoke.TRAIN_BATCH, "seq": smoke.TRAIN_SEQ, "remat": hp.remat,
            **rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2,
                    help="counted steps a turn (four turns)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_probe: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    variants = {"blocks": fa.flash_attention_plain_grads,
                "whole": whole_grads}
    out = {"card": card, "torch": torch.__version__,
           "bwd_query_rows": fa.BWD_QUERY_ROWS}
    out["layer"] = layer_backward(torch, np, smoke, fa, variants)
    print(f"layer: {json.dumps(out['layer'])}", flush=True)
    torch.cuda.empty_cache()
    out["train"] = train_steps(torch, smoke, fa, variants, args.steps)
    dest = ROOT / "chiprun_out" / "train_probe.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
