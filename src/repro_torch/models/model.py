"""Composable decoder model of the serving path: parameter specs, the
super-block loop, prefill and single-token decode.  The port of the
reference's ``models/model.py``.

Parameters are a plain dict of tensors in the reference's layout:
``embed`` (V, d), ``final_ln`` (d,), ``blocks`` (one dict per position of
``cfg.pattern``, each tensor stacked on a leading layer dimension of
``cfg.n_superblocks``) and ``lm_head`` (d, V) unless the embeddings are
tied.  Caches are one (k, v) or (conv_tail, ssm_state) pair per pattern
position, stacked the same way.

Not ported yet, and refused with a ``ValueError`` naming the slice:
MoE layers, M-RoPE and ``input_mode="embeds"`` (ROADMAP Queue 1 item 12),
and training (``loss_fn``, ``chunked_ce_loss``; item 13).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.config import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamSpec, init_params


def check_supported(cfg: ModelConfig):
    """Raise a ``ValueError`` naming the later slice of the port that a
    config needs."""
    if any(spec.mlp == "moe" for spec in cfg.pattern):
        raise ValueError(f"{cfg.name}: MoE layers wait for the MoE slice of "
                         "the port (ROADMAP Queue 1 item 12)")
    if cfg.mrope:
        raise ValueError(f"{cfg.name}: M-RoPE waits for the M-RoPE slice of "
                         "the port (ROADMAP Queue 1 item 12)")
    if cfg.input_mode != "tokens":
        raise ValueError(f"{cfg.name}: input_mode={cfg.input_mode!r} waits "
                         "for the embeds slice of the port (ROADMAP Queue 1 "
                         "item 12)")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    return {
        "wq": ParamSpec((d, Hq, D), "normal", s),
        "wk": ParamSpec((d, Hkv, D), "normal", s),
        "wv": ParamSpec((d, Hkv, D), "normal", s),
        "wo": ParamSpec((Hq, D, d), "normal", (Hq * D) ** -0.5),
    }


def _ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    gn = s.n_groups * s.d_state
    H = d_in // s.head_dim
    sc = d ** -0.5
    return {
        "in_z": ParamSpec((d, d_in), "normal", sc),
        "in_x": ParamSpec((d, d_in), "normal", sc),
        "in_B": ParamSpec((d, gn), "normal", sc),
        "in_C": ParamSpec((d, gn), "normal", sc),
        "in_dt": ParamSpec((d, H), "normal", sc),
        "conv_w": ParamSpec((s.d_conv, d_in + 2 * gn), "normal", 0.2),
        "conv_b": ParamSpec((d_in + 2 * gn,), "zeros"),
        "A_log": ParamSpec((H,), "ones"),
        "D": ParamSpec((H,), "ones"),
        "dt_bias": ParamSpec((H,), "zeros"),
        "gate_ln": ParamSpec((d_in,), "zeros"),
        "out_proj": ParamSpec((d_in, d), "normal", d_in ** -0.5),
    }


def _mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamSpec((d, f), "normal", d ** -0.5),
        "w3": ParamSpec((d, f), "normal", d ** -0.5),
        "w2": ParamSpec((f, d), "normal", f ** -0.5),
    }


def _layer_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    out: Dict[str, ParamSpec] = {"ln": ParamSpec((d,), "zeros")}
    if spec.kind == "attn":
        out.update(_attn_specs(cfg))
    else:
        out.update(_ssm_specs(cfg))
    if cfg.use_post_norm:
        out["ln_post"] = ParamSpec((d,), "zeros")
    if spec.mlp != "none":
        out["ln_mlp"] = ParamSpec((d,), "zeros")
        if cfg.use_post_norm:
            out["ln_mlp_post"] = ParamSpec((d,), "zeros")
        out.update({f"mlp_{k}": v for k, v in _mlp_specs(cfg).items()})
    return out


def _stack(spec_dict: Dict[str, ParamSpec], n: int) -> Dict[str, ParamSpec]:
    return {k: ParamSpec((n,) + v.shape, v.init, v.scale)
            for k, v in spec_dict.items()}


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    tree: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), "normal", 1.0),
        "final_ln": ParamSpec((cfg.d_model,), "zeros"),
        "blocks": [_stack(_layer_specs(cfg, spec), cfg.n_superblocks)
                   for spec in cfg.pattern],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), "normal",
                                    cfg.d_model ** -0.5)
    return tree


# ---------------------------------------------------------------------------
# Layer / super-block application
# ---------------------------------------------------------------------------


def _apply_layer(cfg, spec: LayerSpec, p, x, positions, *, mode, cache,
                 cur_len, attn_impl):
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    if spec.kind == "attn":
        out, new_cache = L.attention_block(
            p, h, positions, cfg, spec, kv_cache=cache, cur_len=cur_len,
            attn_impl=attn_impl, mode=mode)
    else:
        out, new_cache = S.mamba2_block(p, h, cfg, cache=cache, mode=mode)
    if cfg.use_post_norm:
        out = L.rmsnorm(out, p["ln_post"], cfg.norm_eps)
    x = x + out
    if spec.mlp != "none":
        h2 = L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps)
        mp = {k[4:]: v for k, v in p.items() if k.startswith("mlp_")}
        out2 = L.mlp_block(mp, h2, cfg)
        if cfg.use_post_norm:
            out2 = L.rmsnorm(out2, p["ln_mlp_post"], cfg.norm_eps)
        x = x + out2
    return x, new_cache


def run_stack(cfg: ModelConfig, params, x, positions, *, mode: str = "train",
              caches=None, cur_len=None, attn_impl: str = "blocked"):
    """Apply all layers, a Python loop over super-blocks.  Returns
    (hidden, new_caches); new_caches is None in train mode.

    A layer whose new cache is the slice of the stacked buffer it was
    given (attention writes its KV in place) leaves the buffer as it is;
    other new caches (the SSD state and conv tail) are stacked afresh, in
    the dtype the layer computed them in, as the reference's scan does."""
    check_supported(cfg)
    per_layer: List[List[Any]] = [[] for _ in cfg.pattern]
    for i in range(cfg.n_superblocks):
        for pos, spec in enumerate(cfg.pattern):
            p = {k: v[i] for k, v in params["blocks"][pos].items()}
            cache = (None if caches is None else
                     tuple(buf[i] for buf in caches[pos]))
            x, ncache = _apply_layer(cfg, spec, p, x, positions, mode=mode,
                                     cache=cache, cur_len=cur_len,
                                     attn_impl=attn_impl)
            per_layer[pos].append((cache, ncache))
    if mode == "train":
        return x, None
    new_caches = []
    for pos, runs in enumerate(per_layer):
        pair = []
        for part in range(2):
            if caches is not None and all(
                    new[part] is old[part] for old, new in runs):
                pair.append(caches[pos][part])
            else:
                pair.append(torch.stack([new[part] for _, new in runs]))
        new_caches.append(tuple(pair))
    return x, new_caches


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params, batch):
    x = params["embed"][batch["tokens"]]
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)  # gemma
    return x


def _lm_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T      # (d, V)
    return params["lm_head"]


def _logits(cfg, params, hidden_last):
    """(B, d) last hidden states -> (B, V) float32 logits."""
    logits = torch.matmul(hidden_last.float(), _lm_matrix(cfg, params).float())
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def make_positions(cfg: ModelConfig, B: int, S: int, offset=0, device=None):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(B, S)


def init_caches(cfg: ModelConfig, B: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Per-position stacked cache buffers (leading dim n_superblocks)."""
    n = cfg.n_superblocks
    caches = []
    for spec in cfg.pattern:
        if spec.kind == "attn":
            kv_shape = (n, B, max_len, cfg.n_kv_heads, cfg.head_dim)
            caches.append((torch.zeros(kv_shape, dtype=dtype, device=device),
                           torch.zeros(kv_shape, dtype=dtype, device=device)))
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            H = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            caches.append((
                torch.zeros((n, B, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
                torch.zeros((n, B, H, s.head_dim, s.d_state),
                            dtype=torch.float32, device=device)))
    return caches


def forward_hidden(cfg, params, batch, *, mode, caches, cur_len,
                   attn_impl="blocked"):
    x = embed_inputs(cfg, params, batch)
    B, S_ = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S_, offset=cur_len or 0,
                                   device=x.device)
    hidden, new_caches = run_stack(cfg, params, x, positions, mode=mode,
                                   caches=caches, cur_len=cur_len,
                                   attn_impl=attn_impl)
    return L.rmsnorm(hidden, params["final_ln"], cfg.norm_eps), new_caches


def decode_step(cfg: ModelConfig, params, batch, caches, cur_len):
    """One-token decode. batch: tokens (B, 1).  Returns
    (next_token_logits (B, V) float32, new_caches).  The KV buffers of
    ``caches`` are written in place."""
    hidden, new_caches = forward_hidden(cfg, params, batch, mode="decode",
                                        caches=caches, cur_len=int(cur_len))
    return _logits(cfg, params, hidden[:, -1]), new_caches


def prefill(cfg: ModelConfig, params, batch, max_len: int,
            attn_impl="blocked", cache_dtype=torch.bfloat16):
    """Run the prompt, returning (last_hidden, primed caches, prompt_len)."""
    tokens = batch["tokens"]
    B, S_ = tokens.shape[0], tokens.shape[1]
    caches = init_caches(cfg, B, max_len, cache_dtype, device=tokens.device)
    hidden, new_caches = forward_hidden(cfg, params, batch, mode="prefill",
                                        caches=caches, cur_len=0,
                                        attn_impl=attn_impl)
    return hidden, new_caches, S_


def init_model_params(cfg: ModelConfig,
                      generator: Optional[torch.Generator] = None,
                      dtype=torch.float32, *, device="cuda"):
    """Seeded parameters on ``device`` (the card unless the CPU is asked
    for; raises without a card).  ``generator`` must live on ``device``;
    by default it is one seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}")
    return init_params(param_specs(cfg), generator, dtype)
