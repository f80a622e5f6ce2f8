"""Plain reference of Mamba-2 (arXiv:2405.21060): pre-norm blocks of
RMSNorm and the SSD mixer, a final RMSNorm and an LM head.

The mixer: projections of the normed input to z, x, B, C and dt; a
depthwise causal convolution of width ``d_conv`` with bias over the
channels (x, B, C), then SiLU; dt = softplus(dt + dt_bias), A =
-exp(A_log); the SSD

    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{k=s+1..t} dt_k A) dt_s x_s
          + D x_t

per head (B and C shared by the heads of a group), computed here in its
quadratic form over the whole sequence (every query row against every
earlier key), not chunk by chunk; y gated by SiLU(z), then RMSNorm (the
gated norm, normed after the gate), then the output projection.  The
decay exponents come from float64 running sums, so they keep their
precision over thousands of positions.

The weights are the layout ``layout`` gives, stacked on a leading layer
dimension, in the order the benchmark draws them; ``A_log`` and
``dt_bias`` follow Mamba-2's initialisation (A uniform on [1, 16], dt
log-uniform on [0.001, 0.1] through the inverse softplus), so the state
carries information over long spans.  A norm's weight is stored as its
offset from one.  Everything is float32; whether a float32 product may
run in TF32 is the caller's setting.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

QUERY_BLOCK = 256   # query rows a block of the quadratic form


def dims(conf):
    s = conf["ssm_cfg"]
    d = conf["d_model"]
    d_in = s["expand"] * d
    return dict(d=d, d_in=d_in, H=d_in // s["headdim"], P=s["headdim"],
                N=s["d_state"], G=s["ngroups"], K=s["d_conv"],
                V=conf["vocab_size"], L=conf["n_layer"])


def layout(conf):
    m = dims(conf)
    d, d_in, H, N, G, K, V, L = (m[k] for k in ("d", "d_in", "H", "N", "G",
                                                "K", "V", "L"))
    conv = d_in + 2 * G * N
    block = [("ln", (L, d), "zeros", 0.0),
             ("in_z", (L, d, d_in), "normal", d ** -0.5),
             ("in_x", (L, d, d_in), "normal", d ** -0.5),
             ("in_B", (L, d, G * N), "normal", d ** -0.5),
             ("in_C", (L, d, G * N), "normal", d ** -0.5),
             ("in_dt", (L, d, H), "normal", d ** -0.5),
             ("conv_w", (L, K, conv), "normal", 0.2),
             ("conv_b", (L, conv), "zeros", 0.0),
             ("A_log", (L, H), "log_uniform", (1.0, 16.0)),
             ("D", (L, H), "ones", 1.0),
             ("dt_bias", (L, H), "dt_bias", (1e-3, 1e-1)),
             ("gate_ln", (L, d_in), "zeros", 0.0),
             ("out_proj", (L, d_in, d), "normal", d_in ** -0.5)]
    return ([(("embed",), (V, d), "normal", 1.0),
             (("final_ln",), (d,), "zeros", 0.0),
             (("lm_head",), (d, V), "normal", d ** -0.5)]
            + [(("blocks", 0, k), s, i, a) for k, s, i, a in block])


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def causal_conv(u, w, b):
    """Depthwise causal convolution: out_t = sum_i w_i u_{t-K+1+i} + b,
    zeros before the first position.  u (B, S, C), w (K, C)."""
    K = w.shape[0]
    S = u.shape[1]
    padded = F.pad(u, (0, 0, K - 1, 0))
    return sum(padded[:, i:i + S] * w[i] for i in range(K)) + b


def ssd(x, dt, A, Bm, Cm):
    """The quadratic form.  x (R, S, H, P), dt (R, S, H), A (H,), Bm and
    Cm (R, S, G, N).  Returns y (R, S, H, P) without the D term.

    ``QUERY_BLOCK`` query rows at a time, each against the keys up to its
    last row.  The decay exponents sum_{k=s+1..t} dt_k A are differences
    of float64 running sums, offset to the block's first row before they
    are rounded to float32: exact where the decay is not negligible."""
    R, S, H, P = x.shape
    G = Bm.shape[2]
    cum = torch.cumsum((dt * A).double(), dim=1).transpose(1, 2)  # (R,H,S)
    CB = torch.einsum("rtgn,rsgn->rgts", Cm, Bm)                  # (R,G,S,S)
    CB = CB[:, torch.arange(H, device=x.device) // (H // G)]      # (R,H,S,S)
    xh = x.transpose(1, 2)                                        # (R,H,S,P)
    dth = dt.transpose(1, 2)                                      # (R,H,S)
    out = []
    for a in range(0, S, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, S)
        base = cum[:, :, a:a + 1]
        rows = (cum[:, :, a:b] - base).float()
        cols = (cum[:, :, :b] - base).float()
        delta = rows[..., :, None] - cols[..., None, :]           # (R,H,q,b)
        causal = (torch.arange(a, b, device=x.device)[:, None]
                  >= torch.arange(b, device=x.device)[None, :])
        decay = torch.exp(delta.masked_fill(~causal, float("-inf")))
        scores = CB[:, :, a:b, :b] * decay * dth[:, :, None, :b]
        out.append(torch.matmul(scores, xh[:, :, :b]))
    return torch.cat(out, dim=2).transpose(1, 2)


def mixer(conf, p, h):
    m = dims(conf)
    R, S, _ = h.shape
    d_in, H, P, N, G = m["d_in"], m["H"], m["P"], m["N"], m["G"]
    z = h @ p["in_z"]
    u = torch.cat([h @ p["in_x"], h @ p["in_B"], h @ p["in_C"]], dim=-1)
    u = F.silu(causal_conv(u, p["conv_w"], p["conv_b"]))
    xs, Bs, Cs = torch.split(u, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(h @ p["in_dt"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(R, S, H, P)
    y = ssd(xh, dt, A, Bs.reshape(R, S, G, N), Cs.reshape(R, S, G, N))
    y = (y + p["D"][:, None] * xh).reshape(R, S, d_in) * F.silu(z)
    y = rmsnorm(y, p["gate_ln"], conf["norm_epsilon"])
    return y @ p["out_proj"]


def layer_params(params, i):
    return {k: v[i] for k, v in params["blocks"][0].items()}


@torch.no_grad()
def final_hidden(conf, params, tokens):
    """The final-normed hidden states (R, S, d) of the (R, S) token rows,
    each row a whole sequence from position 0."""
    eps = conf["norm_epsilon"]
    x = params["embed"][tokens]
    for i in range(conf["n_layer"]):
        p = layer_params(params, i)
        x = x + mixer(conf, p, rmsnorm(x, p["ln"], eps))
    return rmsnorm(x, params["final_ln"], eps)


@torch.no_grad()
def logits_at(conf, params, tokens, where):
    """Logits (R, len(where), V) at positions ``where``."""
    return final_hidden(conf, params, tokens)[:, where] @ params["lm_head"]
