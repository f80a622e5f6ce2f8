"""Mamba-2 SSD (state-space duality) mixer, arXiv:2405.21060: the port of
the reference's ``models/ssm.py``.

Train/prefill runs the chunked SSD algorithm.  Within a chunk the work is
quadratic and goes to one ``ssd_chunk`` call over all (batch, chunk,
head) cells, which gives both the intra-chunk output and each chunk's
input state (the hand-written kernel on a CUDA tensor, its plain version
on the CPU); the reference computes the same two terms with XLA einsums
and its tests hold them equal to the Pallas kernel
(``tests/test_kernels.py``).  Across chunks the recurrence is a Python
loop carrying the (B, H, P, N) state.  Decode is the O(1)-per-token
recurrence, plain torch on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunk


def ssd_chunked(x, dt, A, B_, C_, *, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (B, S, H, P)   dt: (B, S, H)  (already softplus'd, >0)
    A: (H,)           (negative)
    B_, C_: (B, S, G, N), H % G == 0
    Returns (y (B, S, H, P) float32, final_state (B, H, P, N) float32).
    """
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt=0 tokens: zero input weight, unit decay -> state-neutral
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    hg = H // G  # heads per B/C group

    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H).float()
    Bc = B_.reshape(Bb, nc, Q, G, N)
    Cc = C_.reshape(Bb, nc, Q, G, N)

    dA = dtc * A.float()                                 # (B,nc,Q,H) negative
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumsum

    # ---- intra-chunk output and per-chunk input states: one ssd_chunk
    # call over the M = B*nc*H cells, laid out (b, c, h) so the hg heads
    # of a B/C group are consecutive and read one (b, c, g) row
    def cells(t, width):                                 # (B,nc,Q,K,w)
        return t.permute(0, 1, 3, 2, 4).reshape(-1, Q, width)

    y_cells, states = ssd_chunk(
        cells(xc, P), cells(dtc[..., None], 1), cells(cum[..., None], 1),
        cells(Bc, N), cells(Cc, N))
    y_intra = y_cells.reshape(Bb, nc, H, Q, P).transpose(2, 3)
    chunk_states = states.reshape(Bb, nc, H, P, N)

    # ---- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(dA.sum(dim=2))               # (B,nc,H)
    if initial_state is None:
        h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # ---- inter-chunk output contribution ----------------------------------
    y_inter = torch.einsum(
        "bcqgn,bcgjpn->bcqgjp", Cc.float(),
        prev_states.reshape(Bb, nc, G, hg, P, N)).reshape(Bb, nc, Q, H, P)
    y_inter = y_inter * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y[:, :S_orig], h


def ssd_reference(x, dt, A, B_, C_, *, initial_state=None):
    """O(S) sequential oracle (tests only)."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    hg = H // G
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    dtf = dt.float()
    Bf = B_.repeat_interleave(hg, dim=2).float()         # (B,S,H,N)
    Cf = C_.repeat_interleave(hg, dim=2).float()
    ys = []
    for t in range(S):
        dec = torch.exp(dtf[:, t] * A.float())           # (B,H)
        h = h * dec[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bf[:, t], x[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Full Mamba-2 block
# ---------------------------------------------------------------------------


def _causal_conv(seq, w, b, tail=None):
    """Depthwise causal conv1d as the reference's shifted sums (not
    ``F.conv1d``, which cuDNN runs in TF32 by default on the card).
    seq: (B, S, Cdim); w: (K, Cdim); b: (Cdim,).
    tail: (B, K-1, Cdim) carried context (decode / prefill continuation)."""
    K = w.shape[0]
    Bb, S = seq.shape[0], seq.shape[1]
    if tail is None:
        tail = torch.zeros((Bb, K - 1, seq.shape[-1]), dtype=seq.dtype,
                           device=seq.device)
    full = torch.cat([tail, seq], dim=1)
    out = 0
    for i in range(K):
        out = out + full[:, i:i + S] * w[i][None, None, :]
    new_tail = full[:, -(K - 1):] if K > 1 else tail
    return F.silu(out + b[None, None, :]), new_tail


def mamba2_block(params, x, cfg, *, cache=None, mode: str = "train"):
    """mode: 'train' | 'prefill' | 'decode'.
    cache (decode): (conv_tail (B,K-1,conv_dim), ssm_state (B,H,P,N)).
    Returns (out, new_cache); new_cache is None for train."""
    s = cfg.ssm
    B, S, _ = x.shape
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    H = d_in // s.head_dim
    P = s.head_dim
    N = s.d_state
    G = s.n_groups
    z = torch.einsum("bsd,de->bse", x, params["in_z"])
    xr = torch.einsum("bsd,de->bse", x, params["in_x"])
    Br = torch.einsum("bsd,de->bse", x, params["in_B"])
    Cr = torch.einsum("bsd,de->bse", x, params["in_C"])
    dtr = torch.einsum("bsd,dh->bsh", x, params["in_dt"])

    conv_in = torch.cat([xr, Br, Cr], dim=-1)
    tail_in = cache[0] if cache is not None else None
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], tail=tail_in)
    xr, Br, Cr = torch.split(conv_out, [d_in, gn, gn], dim=-1)

    xh = xr.reshape(B, S, H, P)
    Bm = Br.reshape(B, S, G, N)
    Cm = Cr.reshape(B, S, G, N)
    dt = F.softplus(dtr.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())

    init_state = cache[1] if cache is not None else None
    if mode == "decode" and S == 1:
        # O(1) recurrence
        h = init_state.float()
        hg = H // G
        Bh = Bm.repeat_interleave(hg, dim=2)[:, 0]       # (B,H,N)
        Ch = Cm.repeat_interleave(hg, dim=2)[:, 0]
        dt0 = dt[:, 0]                                   # (B,H)
        dec = torch.exp(dt0 * A)
        h = h * dec[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt0, Bh, xh[:, 0].float())
        y = torch.einsum("bhn,bhpn->bhp", Ch, h)[:, None]  # (B,1,H,P)
        new_state = h
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk=s.chunk,
                                   initial_state=init_state)

    y = y + xh.float() * params["D"].float()[:, None]
    y = y.reshape(B, S, d_in)
    y = y * F.silu(z.float())
    # gated RMSNorm
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * (1.0 + params["gate_ln"].float())
    y = y.to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])

    new_cache = None if mode == "train" else (new_tail, new_state)
    return out, new_cache
