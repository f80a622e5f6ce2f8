"""Serving steps: batched prefill plus single-token decode, greedy
sampling, and the generation driver.  The port of the reference's
``serve/decode.py``.

Each takes a ``ctx`` (``models.sharding.ShardingCtx``) as the
reference's does: every rank of ``ctx.mesh`` then calls it with the same
global batch and its own blocks of the parameters
(``sharding.shard_params``) and caches (``sharding.RankCaches``), and
gets the whole batch's logits and tokens back, the same on every rank
(the greedy argmax, the first maximum, taken over the gathered
logits)."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.models import model as M
from repro_torch.models.sharding import RankLayout


def make_prefill_step(cfg: ModelConfig, ctx=None, *,
                      max_len: Optional[int] = None, attn_impl="blocked",
                      cache_dtype=torch.bfloat16):
    """Returns fn(params, batch) -> (first_token_logits (B, V), caches)."""

    def prefill_step(params, batch):
        hidden, caches, layout = M._prefill(
            cfg, params, batch, max_len or prompt_len(batch), ctx,
            attn_impl, cache_dtype)
        return M._logits(cfg, params, hidden[:, -1], layout), caches

    return prefill_step


def prompt_len(batch) -> int:
    """The sequence length of a batch of ``tokens`` (B, S) or ``embeds``
    (B, S, d)."""
    return batch.get("tokens", batch.get("embeds")).shape[1]


def make_serve_step(cfg: ModelConfig, ctx=None):
    """One new token with an existing KV/SSM cache.

    fn(params, batch, caches, cur_len) -> (next_token (B,), logits,
    caches)."""

    def serve_step(params, batch, caches, cur_len):
        logits, new_caches = M.decode_step(cfg, params, batch, caches,
                                           cur_len, ctx)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_caches

    return serve_step


def step_batch(cfg: ModelConfig, params, tok: torch.Tensor, cur: int,
               layout=None):
    """The decode batch of the (B,) tokens ``tok`` at position ``cur``:
    ``tokens`` (B, 1), or in an ``embeds`` config their rows of the token
    table, (B, 1, d); under M-RoPE also ``positions``, (3, B, 1) filled
    with ``cur``.  With a serving ``layout`` the rows come from this
    rank's block of the table (the vocab-parallel lookup), whole on
    every rank."""
    if cfg.input_mode == "embeds":
        if layout is None:
            batch = {"embeds": params["embed"][tok][:, None]}
        else:
            whole = dataclasses.replace(layout, embed_axes=())
            batch = {"embeds": M.embed_tokens(cfg, params, tok[:, None],
                                              whole)}
    else:
        batch = {"tokens": tok[:, None]}
    if cfg.mrope:
        batch["positions"] = torch.full((3, tok.shape[0], 1), cur,
                                        dtype=torch.int32, device=tok.device)
    return batch


def generate(cfg: ModelConfig, params, prompt_batch, *, max_new_tokens: int,
             ctx=None, attn_impl="blocked", cache_dtype=torch.float32,
             device="cuda", walls: Optional[dict] = None):
    """Greedy generation (prefill, then a decode loop) on ``device`` (the
    card unless the CPU is asked for; raises without a card).  The
    parameters must already lie there; the prompt batch (``tokens`` or
    ``embeds``, and ``positions`` if given) is moved.  In an ``embeds``
    config each decode step embeds its token with the token table (the
    reference's modality-frontend stub); under M-RoPE it passes the
    position ``cur`` on all three axes.  Returns (B, max_new_tokens) int32
    tokens on ``device``.  Under ``ctx`` (see the module's note) every
    rank passes the same prompt and its blocks of the parameters, and
    gets the same tokens.

    ``walls``, when given, receives ``prefill_s`` and ``decode_s``: host
    seconds, each span ending in a device synchronise."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters on {params['embed'].device}, "
                         f"generate on {dev}")
    prompt = {k: torch.as_tensor(v, device=dev)
              for k, v in prompt_batch.items()}
    S = prompt_len(prompt)
    prefill_step = make_prefill_step(cfg, ctx, max_len=S + max_new_tokens,
                                     attn_impl=attn_impl,
                                     cache_dtype=cache_dtype)
    serve_step = make_serve_step(cfg, ctx)
    layout = None
    if ctx is not None:
        B = prompt.get("tokens", prompt.get("embeds")).shape[0]
        layout = RankLayout.for_serving(ctx, cfg, B, S + max_new_tokens)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = sync() if walls is not None else None
    logits, caches = prefill_step(params, prompt)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if walls is not None:
        t1 = sync()
    out = [tok]
    cur = S
    for _ in range(max_new_tokens - 1):
        batch = step_batch(cfg, params, tok, cur, layout)
        tok, _, caches = serve_step(params, batch, caches, cur)
        out.append(tok)
        cur += 1
    if walls is not None:
        walls["prefill_s"] = t1 - t0
        walls["decode_s"] = sync() - t1
    return torch.stack(out, dim=1)
