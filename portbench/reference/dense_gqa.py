"""Plain reference of a dense decoder with grouped-query attention, as
InternLM2 (arXiv:2403.17297) describes it: pre-norm blocks of RMSNorm,
causal softmax attention with RoPE (the rotate-half form) and ``H_kv``
key/value heads each shared by ``H / H_kv`` query heads, then RMSNorm
and a SwiGLU MLP; a final RMSNorm and an untied LM head.

The weights are the layout ``layout`` gives, stacked on a leading layer
dimension, in the order the benchmark draws them.  A norm's weight is
stored as its offset from one (the scale is ``1 + w``).  Everything is
float32; whether a float32 product may run in TF32 is the caller's
setting (off for the reference, on for the control).

Serving: ``logits_at`` runs whole sequences (no cache: every position
attends to every earlier one in one pass, a block of query rows at a
time) and returns the logits at the positions asked for.  Training:
``loss`` is the mean next-token cross-entropy, each layer under
``torch.utils.checkpoint`` so that three steps of the whole model fit
beside the optimiser state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

QUERY_BLOCK = 1024      # query rows a block of the serving attention
CE_BLOCK = 1024         # positions a block of the cross-entropy


def dims(conf):
    d = conf["hidden_size"]
    H = conf["num_attention_heads"]
    return dict(d=d, H=H, Hkv=conf["num_key_value_heads"], D=d // H,
                f=conf["intermediate_size"], V=conf["vocab_size"],
                L=conf["num_hidden_layers"])


def layout(conf):
    """(path, shape, init, std) of every weight, in drawing order."""
    m = dims(conf)
    d, H, Hkv, D, f, V, L = (m[k] for k in ("d", "H", "Hkv", "D", "f",
                                            "V", "L"))
    block = [("ln", (L, d), "zeros", 0.0),
             ("wq", (L, d, H, D), "normal", d ** -0.5),
             ("wk", (L, d, Hkv, D), "normal", d ** -0.5),
             ("wv", (L, d, Hkv, D), "normal", d ** -0.5),
             ("wo", (L, H, D, d), "normal", (H * D) ** -0.5),
             ("ln_mlp", (L, d), "zeros", 0.0),
             ("mlp_w1", (L, d, f), "normal", d ** -0.5),
             ("mlp_w3", (L, d, f), "normal", d ** -0.5),
             ("mlp_w2", (L, f, d), "normal", f ** -0.5)]
    return ([(("embed",), (V, d), "normal", 1.0),
             (("final_ln",), (d,), "zeros", 0.0),
             (("lm_head",), (d, V), "normal", d ** -0.5)]
            + [(("blocks", 0, k), s, i, a) for k, s, i, a in block])


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x, pos, theta):
    """x (B, S, H, D) turned by positions ``pos`` (S,): the pair (i,
    i + D/2) by pos / theta^(2i/D).  The angles are float32, as the
    published implementation computes them (``inv_freq = 1 / base **
    (arange(0, D, 2).float() / D)``, then the float32 outer product with
    the positions)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block=None):
    """Causal softmax attention.  q (B, S, H, D), k and v (B, S, Hkv, D):
    query head h reads key/value head h // (H / Hkv).  ``block`` query
    rows at a time, each against the keys up to its last row."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)     # (B, H, S, D)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    block = block or S
    outs = []
    for a in range(0, S, block):
        b = min(a + block, S)
        s = torch.matmul(q[:, :, a:b], k[:, :, :b].transpose(-1, -2))
        s = s / math.sqrt(D)
        mask = (torch.arange(a, b, device=q.device)[:, None]
                >= torch.arange(b, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v[:, :, :b]))
    return torch.cat(outs, dim=2).transpose(1, 2)           # (B, S, H, D)


def layer(conf, p, x, pos, block=None):
    eps = conf["rms_norm_eps"]
    h = rmsnorm(x, p["ln"], eps)
    q = rope(torch.einsum("bsd,dhk->bshk", h, p["wq"]), pos,
             conf["rope_theta"])
    k = rope(torch.einsum("bsd,dhk->bshk", h, p["wk"]), pos,
             conf["rope_theta"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    o = attention(q, k, v, block)
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"])
    h = rmsnorm(x, p["ln_mlp"], eps)
    g = F.silu(h @ p["mlp_w1"]) * (h @ p["mlp_w3"])
    return x + g @ p["mlp_w2"]


def layer_params(params, i):
    return {k: v[i] for k, v in params["blocks"][0].items()}


@torch.no_grad()
def final_hidden(conf, params, tokens):
    """The final-normed hidden states (B, S, d) of the (B, S) token rows,
    each row a whole sequence from position 0."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens]
    for i in range(conf["num_hidden_layers"]):
        x = layer(conf, layer_params(params, i), x, pos, QUERY_BLOCK)
    return rmsnorm(x, params["final_ln"], conf["rms_norm_eps"])


@torch.no_grad()
def logits_at(conf, params, tokens, where):
    """Logits (B, len(where), V) at positions ``where``."""
    return final_hidden(conf, params, tokens)[:, where] @ params["lm_head"]


def _ce_block(h, w_final, lm_head, targets, eps):
    logits = rmsnorm(h, w_final, eps) @ lm_head
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum")


def loss(conf, params, tokens, targets):
    """Mean next-token cross-entropy of (B, S) ``targets`` given (B, S)
    ``tokens``, differentiable in ``params``."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens]
    for i in range(conf["num_hidden_layers"]):
        x = checkpoint.checkpoint(
            lambda x, p: layer(conf, p, x, pos), x, layer_params(params, i),
            use_reentrant=False)
    total = 0.0
    for a in range(0, S, CE_BLOCK):
        total = total + checkpoint.checkpoint(
            _ce_block, x[:, a:a + CE_BLOCK], params["final_ln"],
            params["lm_head"], targets[:, a:a + CE_BLOCK],
            conf["rms_norm_eps"], use_reentrant=False)
    return total / targets.numel()
