"""Serving launcher: the batched-request generation driver (the port of the
reference's ``launch/serve.py``).

Requests arrive with different prompt lengths; each wave of ``batch``
requests is left-padded with token 0 to its longest prompt, prefilled
once, then decoded step by step with the shared KV/SSM cache.  As in the
reference, no mask reaches ``generate``: the pad tokens are attended.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b

runs the reduced config of ``--arch`` on ``--device`` (default the card).
It serves token prompts, as the reference's server does; an ``embeds``
config (musicgen-medium, qwen2-vl-72b) is served through
``serve.decode.generate`` with prompt embeddings.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.decode import generate


def make_requests(vocab_size: int, n_requests: int, max_len: int,
                  max_new: int, seed: int) -> List[np.ndarray]:
    """The reference's request queue: prompt lengths in
    [4, max_len - max_new), tokens uniform over the vocabulary."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab_size, size=rng.randint(4, max_len - max_new))
            for _ in range(n_requests)]


def waves(requests: List[np.ndarray], batch: int) -> List[np.ndarray]:
    """The requests in waves of ``batch``, each left-padded with token 0 to
    its longest prompt: a list of (len(wave), L) int32 arrays."""
    out = []
    for i in range(0, len(requests), batch):
        wave = requests[i:i + batch]
        L = max(len(p) for p in wave)
        toks = np.zeros((len(wave), L), np.int32)
        for j, p in enumerate(wave):
            toks[j, L - len(p):] = p
        out.append(toks)
    return out


def serve(cfg: ModelConfig, params, requests: List[np.ndarray], *,
          batch: int, max_new: int, device="cuda"
          ) -> Tuple[List[np.ndarray], List[Dict[str, float]]]:
    """Serve ``requests`` wave by wave with greedy ``generate`` on
    ``device``.  Returns the tokens of each wave ((len(wave), max_new)
    int32 arrays) and its walls (``prompt_len``, ``prefill_s``,
    ``decode_s``, ``wall_s``; host seconds ending in a device
    synchronise).  Raises a ``ValueError`` on an ``embeds`` config: its
    prompts are embeddings, which ``generate`` takes."""
    if cfg.input_mode != "tokens":
        raise ValueError(f"{cfg.name}: serve() answers token prompts; an "
                         f"input_mode={cfg.input_mode!r} config takes "
                         "prompt embeddings through serve.decode.generate")
    tokens, walls = [], []
    for toks in waves(requests, batch):
        w: Dict[str, float] = {"prompt_len": toks.shape[1]}
        t0 = time.perf_counter()
        out = generate(cfg, params, {"tokens": torch.from_numpy(toks)},
                       max_new_tokens=max_new, device=device, walls=w)
        tokens.append(out.cpu().numpy())
        w["wall_s"] = time.perf_counter() - t0
        walls.append(w)
    return tokens, walls


def main():
    ap = argparse.ArgumentParser(description="repro_torch server (batched)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_reduced
    from repro_torch.core.config import resolve_device
    from repro_torch.models import model as M

    cfg = get_reduced(args.arch)
    dev = resolve_device(args.device)
    params = M.init_model_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    queue = make_requests(cfg.vocab_size, args.n_requests, args.max_len,
                          args.max_new, args.seed)
    t0 = time.perf_counter()
    tokens, walls = serve(cfg, params, queue, batch=args.batch,
                          max_new=args.max_new, device=dev)
    for out, w in zip(tokens, walls):
        print(f"wave of {out.shape[0]}: prompt_len<= {w['prompt_len']}, "
              f"generated {out.shape[1]} tokens/req "
              f"sample={out[0, :8].tolist()}")
    dt = time.perf_counter() - t0
    print(f"served {len(queue)} requests in {dt:.2f}s "
          f"({len(queue) * args.max_new / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
