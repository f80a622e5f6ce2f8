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

Under a ``models.sharding.RankLayout`` (serving and training; the
reference's ``ssm_in`` split, its ``models/ssm.py:150-219``): ``in_z``,
``in_x``,
``gate_ln`` and ``out_proj`` hold this rank's block of the inner dim,
``in_B``/``in_C``/``in_dt``/``A_log``/``D``/``dt_bias`` are whole.  The
packed conv channels (x, then B, then C) are split by their own spec,
whose block boundaries do not meet the x/B/C boundaries: the rank
gathers the x channels (an activation), convolves its block of the
packed channels with its blocks of ``conv_w``/``conv_b`` and its block
of the conv tail cache, and gathers the conv output back, from which it
takes its x channels and the whole B and C.  The SSD runs on the heads
of the rank's block of the state cache, the gated RMSNorm's sum of
squares is summed over the ranks of the inner dim and ``out_proj`` is
row-parallel, one sum.  Both caches hold the blocks the reference's
``cache_logical_axes`` give, so ``sharding.gather_caches`` returns its
layout.  In training every message has its backward: ``x`` enters the
inner channels' ranks through ``copy_to``; B, C and dt, whole on every
rank, enter the conv's blocks and the heads through ``copy_to``; the
gradients of the gathered x channels and of the gathered conv output
are summed over the ranks that read different parts of them and cut to
the rank's block (a reduce-scatter); the gated norm's sum of squares is
summed both ways; ``out_proj`` is row-parallel, its input entering the
d_model blocks' ranks through ``copy_to`` under the 2-D tables.  The
SSD always runs on the rank's heads over the whole sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.models.collectives import (all_gather, all_reduce,
                                            copy_to, own_block, shared_sum)
from repro_torch.models.layers import contract_d, out_d, sum_parts
from repro_torch.models.sharding import STATE_AXES, entry_axes


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


def mamba2_block(params, x, cfg, *, cache=None, mode: str = "train",
                 layout=None, specs=None):
    """mode: 'train' | 'prefill' | 'decode'.
    cache (decode): (conv_tail (B,K-1,conv_dim), ssm_state (B,H,P,N)).
    Returns (out, new_cache); new_cache is None for train.  With a
    serving ``layout``, this rank's rows, blocks and caches (see the
    module's note)."""
    if layout is not None:
        return _mamba2_sharded(params, x, cfg, cache, mode, layout, specs)
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
        # float32 as the state (jnp.einsum promotes a bf16 operand)
        Bh = Bm.repeat_interleave(hg, dim=2)[:, 0].float()   # (B,H,N)
        Ch = Cm.repeat_interleave(hg, dim=2)[:, 0].float()
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


def _alike_to(x, dim, axes, diff, mesh):
    """``x``, this rank's block of ``dim`` over ``axes``, gathered whole
    (each rank then holding the same tensor), where the ranks of
    ``diff`` then read different parts of it: the backward sums the
    gradient over ``diff`` and takes this rank's block (a reduce-scatter
    where ``diff`` is ``axes``)."""
    if axes:
        return all_gather(x, dim, axes, mesh, sum_axes=diff)
    return copy_to(x, diff, mesh)


def _mamba2_sharded(params, x, cfg, cache, mode, layout, specs):
    s = cfg.ssm
    B, S, _ = x.shape
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    H, P, G = d_in // s.head_dim, s.head_dim, s.n_groups
    mesh = layout.mesh
    x_ax = layout.tp_axes(specs["in_x"][1])      # inner channels
    k_ax = layout.tp_axes(specs["conv_w"][1])    # packed conv channels
    state = layout.ctx.spec_for((1, layout.batch_size, H, P, s.d_state),
                                STATE_AXES)
    h_ax = tuple(a for a in entry_axes(state[2]) if mesh.shape[a] > 1)
    # z and x: this rank's inner channels (x enters through copy_to over
    # their axes); B, C and dt: whole on every rank, entering work that
    # differs between ranks (the conv's blocks, the heads) through
    # copy_to over those axes
    xu, ws, red = contract_d(copy_to(x, x_ax, mesh),
                             [params["in_z"], params["in_x"]], 0, layout,
                             specs["in_z"][0])
    xw, wb, _ = contract_d(x, [params[n] for n in ("in_B", "in_C",
                                                    "in_dt")], 0, layout,
                           specs["in_B"][0])
    z, xr, Br, Cr, dtr = sum_parts(
        [torch.einsum("bsd,de->bse", xu, w) for w in ws]
        + [torch.einsum("bsd,de->bse", xw, w) for w in wb], red, mesh)
    BC = copy_to(torch.cat([Br, Cr], dim=-1), k_ax, mesh)
    dtr = copy_to(dtr, h_ax, mesh)

    conv_in = torch.cat([_alike_to(xr, -1, x_ax, k_ax, mesh), BC], dim=-1)
    if k_ax:
        conv_in = own_block(conv_in, -1, k_ax, mesh)
    tail_in = cache[0] if cache is not None else None
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], tail=tail_in)
    conv_out = _alike_to(conv_out, -1, k_ax, h_ax, mesh)

    # the SSD on the heads of this rank's block of the state
    hl = H // (mesh.size(h_ax) if h_ax else 1)
    h0 = (mesh.block_index(h_ax) if h_ax else 0) * hl
    xh = conv_out[..., h0 * P:(h0 + hl) * P].reshape(B, S, hl, P)
    Bm = conv_out[..., d_in:d_in + gn].reshape(B, S, G, s.d_state)
    Cm = conv_out[..., d_in + gn:].reshape(B, S, G, s.d_state)
    hg = H // G
    if G > 1:
        if h0 % hg == 0 and hl % hg == 0:
            Bm = Bm[:, :, h0 // hg:(h0 + hl) // hg]
            Cm = Cm[:, :, h0 // hg:(h0 + hl) // hg]
        else:       # one group a head
            Bm = Bm.repeat_interleave(hg, dim=2)[:, :, h0:h0 + hl]
            Cm = Cm.repeat_interleave(hg, dim=2)[:, :, h0:h0 + hl]
    heads = slice(h0, h0 + hl)
    dt_bias, A_log, D_ = (copy_to(params[n], h_ax, mesh)[heads]
                          for n in ("dt_bias", "A_log", "D"))
    dt = F.softplus(dtr[..., heads].float() + dt_bias)
    A = -torch.exp(A_log.float())

    init_state = cache[1] if cache is not None else None
    if mode == "decode" and S == 1:
        h = init_state.float()
        g_loc = Bm.shape[2]
        Bh = Bm.repeat_interleave(hl // g_loc, dim=2)[:, 0].float()
        Ch = Cm.repeat_interleave(hl // g_loc, dim=2)[:, 0].float()
        dt0 = dt[:, 0]
        h = h * torch.exp(dt0 * A)[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt0, Bh, xh[:, 0].float())
        y = torch.einsum("bhn,bhpn->bhp", Ch, h)[:, None]
        new_state = h
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk=s.chunk,
                                   initial_state=init_state)

    y = y + xh.float() * D_.float()[:, None]
    y = y.reshape(B, S, hl * P)
    if h_ax != x_ax:        # z on this rank's heads' channels
        z = _alike_to(z, -1, x_ax, h_ax, mesh)[..., h0 * P:(h0 + hl) * P]
    y = y * F.silu(z.float())
    # gated RMSNorm: the sum of squares over every rank's channels
    ss = shared_sum((y * y).sum(-1, keepdim=True), h_ax, mesh)
    y = y * torch.rsqrt(ss / d_in + cfg.norm_eps)
    if h_ax != x_ax:        # this rank's block of the inner channels
        xl = d_in // (mesh.size(x_ax) if x_ax else 1)
        x0 = (mesh.block_index(x_ax) if x_ax else 0) * xl - h0 * P
        y = copy_to(y, x_ax, mesh)[..., x0:x0 + xl]
    y = (y * (1.0 + params["gate_ln"].float())).to(x.dtype)
    y, w_out, g_ax = out_d(y, params["out_proj"], 1, layout,
                           specs["out_proj"][1])
    out = all_reduce(torch.einsum("bse,ed->bsd", y, w_out), x_ax, mesh)
    if g_ax:
        out = all_gather(out, -1, g_ax, mesh)
    new_cache = None if mode == "train" else (new_tail, new_state)
    return out, new_cache
