"""Serving steps: batched prefill plus single-token decode, greedy
sampling, and the generation driver.  The port of the reference's
``serve/decode.py``."""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, *, max_len: Optional[int] = None,
                      attn_impl="blocked", cache_dtype=torch.bfloat16):
    """Returns fn(params, batch) -> (first_token_logits (B, V), caches)."""

    def prefill_step(params, batch):
        hidden, caches, _ = M.prefill(
            cfg, params, batch, max_len=max_len or batch["tokens"].shape[1],
            attn_impl=attn_impl, cache_dtype=cache_dtype)
        return M._logits(cfg, params, hidden[:, -1]), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One new token with an existing KV/SSM cache.

    fn(params, batch, caches, cur_len) -> (next_token (B,), logits,
    caches)."""

    def serve_step(params, batch, caches, cur_len):
        logits, new_caches = M.decode_step(cfg, params, batch, caches,
                                           cur_len)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_caches

    return serve_step


def generate(cfg: ModelConfig, params, prompt_batch, *, max_new_tokens: int,
             attn_impl="blocked", cache_dtype=torch.float32, device="cuda",
             walls: Optional[dict] = None):
    """Greedy generation (prefill, then a decode loop) on ``device`` (the
    card unless the CPU is asked for; raises without a card).  The
    parameters must already lie there; the prompt's tokens are moved.
    Returns (B, max_new_tokens) int32 tokens on ``device``.

    ``walls``, when given, receives ``prefill_s`` and ``decode_s``: host
    seconds, each span ending in a device synchronise."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters on {params['embed'].device}, "
                         f"generate on {dev}")
    tokens = torch.as_tensor(prompt_batch["tokens"], device=dev)
    S = tokens.shape[1]
    prefill_step = make_prefill_step(cfg, max_len=S + max_new_tokens,
                                     attn_impl=attn_impl,
                                     cache_dtype=cache_dtype)
    serve_step = make_serve_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync() if walls is not None else None
    logits, caches = prefill_step(params, {"tokens": tokens})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if walls is not None:
        t1 = sync()
    out = [tok]
    cur = S
    for _ in range(max_new_tokens - 1):
        tok, _, caches = serve_step(params, {"tokens": tok[:, None]}, caches,
                                    cur)
        out.append(tok)
        cur += 1
    if walls is not None:
        walls["prefill_s"] = t1 - t0
        walls["decode_s"] = sync() - t1
    return torch.stack(out, dim=1)
