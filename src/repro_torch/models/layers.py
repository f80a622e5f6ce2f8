"""Model layers: RMSNorm, RoPE and M-RoPE, GQA attention (the
flash_attention kernel for train/prefill, a plain single-token path for
decode), the SwiGLU/GeGLU MLP and the token-choice top-k MoE.  The port of
the reference's ``models/layers.py``; activations keep its (B, S, H, D)
layout.

Attention.  In train/prefill mode the default ``attn_impl`` ("blocked")
calls the ``flash_attention`` wrapper, which is GQA-native: no KV repeat,
and the (B, S, H, D) projections go in as strided (B, H, S, D) views.  On
a CUDA tensor that is the hand-written kernel; on the CPU, its plain
version.  The reference computes the same function with the XLA
``blocked_attention``; its tests hold the two equal
(``tests/test_kernels.py``).  ``attn_impl="reference"`` keeps the naive
oracle.  Decode is ``decode_attention``, plain torch on every device, as
in the reference (it is not a Pallas kernel there).  In train mode the
wrapper is differentiable: its autograd Function runs the kernel forward
and recomputes the plain version's gradients in the backward.

MoE.  ``moe_block`` is the reference's dropping dispatch with one
dispatch group (the reference's group count without a sharding context):
router softmax in float32, top-k, a stable sort of the (token, k) choices
by expert, capacity ``C`` a expert, overflowing choices dropped.  Its
dispatch is plain torch ops and its expert products ``torch.einsum``, as
the reference computes them outside any Pallas kernel.  In train mode
it also returns the router's stats (``aux_loss``, ``expert_load``), which
the training loss reads.  ``groups`` > 1 splits the tokens into that
many contiguous dispatch groups, capacity and dropping counted per
group, as the reference's ``_moe_groups`` splits them under a mesh: one
process then computes the function a sharded run computes.

Sharding.  With a ``layout`` (``models.sharding.RankLayout``) the blocks
run on this rank's batch rows and on parameters whose FSDP dims the
caller gathered; ``specs`` give each parameter's spec after that gather.
A dim left split over a mesh axis that does not split the batch is
tensor parallelism: ``wq``/``wk``/``wv`` column-parallel over their
heads, ``wo`` row-parallel then a sum over those axes; ``w1``/``w3``
column- and ``w2`` row-parallel; MoE experts (or, where ``expert``
falls back, their d_ff) split, each rank computing its part of every
token's output, then one sum.  Where the kv heads are whole on every
rank while the q heads are split, a rank pairs its q head ``h`` with kv
head ``h // G`` of the global numbering.  ``models.collectives`` brackets
each such region (``copy_to`` in, ``all_reduce`` out) so that every
rank's gradients are its exact share.  ``moe_block_ep`` is the
reference's expert-parallel block: each data shard routes its own
tokens, the rank runs its ``E / ep`` experts (the ``mine`` mask), one
sum over 'model' combines them, ``aux_loss`` is the mean of the data
shards' own and ``expert_load`` the experts' slices gathered over
'model' and summed over the batch axes; it falls back to the dense
block where the reference does (no 'model' axis, ``E % model``, shared
experts).

On d_model blocks (serving, ``RankLayout.for_serving``, and training
under the 2-D tables, ``RankLayout.for_batch``).  Where the ``embed``
rule splits d_model, the activations are this rank's block of it: the
norms sum their squares over those axes, every projection is a partial
product over the rank's d block summed in one message (``contract_d``:
q/k/v together, w1/w3 together, the router's logits before its top-k),
and a down projection writes the rank's block (``out_d``).  With
``gather_fsdp=False`` the weights keep their FSDP d blocks, so no
weight is gathered.  In training each message has its backward: a sum
of partial products is ``all_reduce``; a sum of squares each rank
applies to its own block is summed both ways (``shared_sum``); an
input alike on ranks that then read different blocks of it (a down
projection's input, a whole weight or activation cut to a block)
enters through ``copy_to``.  The KV cache holds the rank's block
of positions (``write_block`` writes only the positions it holds); a
decode step attends over it and returns its partial softmax
(``decode_attention_block``), which ``combine_blocks`` merges over the
kv_seq axes: the max of the blocks' maxima, then one sum of the
rescaled outputs and sums.  When the q heads are split over an axis the
positions are also split over, the ranks of that group gather every q
head first and keep their own heads' output after the combine.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.collectives import (all_gather, all_reduce,
                                            all_reduce_max, copy_to, gather,
                                            own_block, reduce, shared_sum)
from repro_torch.models.sharding import entry_axes

_NEG_INF = -1e30
ATTN_IMPLS = ("blocked", "reference")


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            layout=None):
    """RMSNorm over the last dim.  With a ``layout`` whose activations
    split d_model over ``embed_axes``, ``x`` is this rank's block: the
    sum of squares is summed over those axes (in the backward too: each
    rank applies it to its own block), and the block of ``w`` scales it
    (``w``'s gradient summed over those axes)."""
    xf = x.float()
    ex = () if layout is None else layout.embed_axes
    if ex:
        mesh = layout.mesh
        ss = shared_sum((xf * xf).sum(-1, keepdim=True), ex, mesh)
        var = ss / (x.shape[-1] * mesh.size(ex))
        w = own_block(copy_to(w, ex, mesh), 0, ex, mesh)
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _apply_rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    # x: (..., D); cos/sin broadcastable (..., D/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    ang = positions[..., None].float() * inv                    # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _apply_rot(x, cos, sin)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL style (t, h, w) split of the D/2 frequency dims:
    head_dim=128 -> (16, 24, 24), the published mrope_section."""
    half = head_dim // 2
    t = head_dim // 8
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions_thw: (3, B, S) int (temporal, height,
    width): each section of the frequencies turns by its own position."""
    inv = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    ang_all = positions_thw[..., None].float() * inv            # (3,B,S,D/2)
    ang = torch.cat([part[i] for i, part in enumerate(torch.split(
        ang_all, mrope_sections(x.shape[-1]), dim=-1))], dim=-1)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _apply_rot(x, cos, sin)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _softcap(scores: torch.Tensor, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def repeat_kv(k: torch.Tensor, n_rep: int):
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def reference_attention(q, k, v, *, scale, causal=True, window=None,
                        softcap=None):
    """Naive O(S^2)-memory oracle.  q, k, v: (B, S, H, D)."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = _softcap(s * scale, softcap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return o.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *, scale, window=None,
                     softcap=None):
    """Single-token attention against a KV cache, GQA-native.

    q: (B, 1, Hq, D); k_cache/v_cache: (B, S, Hkv, D); cur_len: an int or
    a (B,) tensor, the number of valid cache positions.  Returns
    (B, 1, Hq, D)."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    # a Python int becomes a device fill, not a host-to-device copy: the
    # copy would synchronise the host with the card in every layer
    cur_b = (cur_len.to(q.device) if torch.is_tensor(cur_len) else
             torch.full((), cur_len, device=q.device)).expand(B)
    mask = pos[None, :] < cur_b[:, None]                        # (B, S)
    if window is not None:
        mask &= pos[None, :] >= (cur_b[:, None] - window)
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.float())
    # (B, Hkv, G, 1, D) -> (B, 1, Hq, D)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + attention + out proj)
# ---------------------------------------------------------------------------


def attention_block(params, x, positions, cfg, spec, *, kv_cache=None,
                    cur_len=None, attn_impl: str = "blocked",
                    mode: str = "train", layout=None, specs=None):
    """Full attention layer. x: (B, S, d).

    mode='train'   : no cache I/O, causal attention.
    mode='prefill' : kv_cache = (k_buf, v_buf) sized (B, max_len, Hkv, D);
                     writes the S fresh KV at cur_len, attends within the
                     prompt, returns the buffers.
    mode='decode'  : S==1; writes at cur_len, attends against the cache.

    The cache buffers are written in place (the reference returns updated
    copies): the returned cache is the (k_buf, v_buf) passed in.

    With a ``layout`` (train mode), this rank's q heads and their kv
    heads (see the module's note); on a block of d_model (the ``embed``
    axes, or weights whose d stays split), the serving path's
    projections, differentiable."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}; allowed: {ATTN_IMPLS}")
    if layout is not None and (mode != "train" or d_blocks(layout, specs,
                                                            "wq")):
        return _attention_serve(params, x, positions, cfg, spec, kv_cache,
                                cur_len, attn_impl, mode, layout, specs)
    S = x.shape[1]
    D = cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else D ** -0.5
    window = cfg.window if spec.attn_type == "local" else None

    wk, wv, tp, kv_whole = params["wk"], params["wv"], (), False
    if layout is not None:
        mesh = layout.mesh
        tp = layout.tp_axes(specs["wq"][1])
        tp_kv = layout.tp_axes(specs["wk"][1])
        if tp_kv not in ((), tp):
            raise ValueError(f"q heads split over {tp}, kv heads over "
                             f"{tp_kv}")
        x = copy_to(x, tp, mesh)
        kv_whole = bool(tp) and not tp_kv
        if kv_whole:
            # every rank holds every kv head and reads some: their
            # weights' gradients are partial sums over the q heads' ranks
            wk, wv = copy_to(wk, tp, mesh), copy_to(wv, tp, mesh)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])          # (B,S,Hq,D)
    k = torch.einsum("bsd,dhk->bshk", x, wk)                    # (B,S,Hkv,D)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    rope = apply_mrope if cfg.mrope else apply_rope
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_whole:
        k, v = _kv_of_heads(k, v, q.shape[2], cfg, layout.mesh.block_index(tp))

    if mode in ("train", "prefill"):
        if attn_impl == "reference":
            G = q.shape[2] // k.shape[2]
            o = reference_attention(q, repeat_kv(k, G), repeat_kv(v, G),
                                    scale=scale, causal=True, window=window,
                                    softcap=cfg.attn_softcap)
        else:
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=scale, causal=True,
                                window=window,
                                softcap=cfg.attn_softcap).transpose(1, 2)
        if mode == "train" or kv_cache is None:
            new_cache = None
        else:
            k_cache, v_cache = kv_cache
            off = 0 if cur_len is None else int(cur_len)
            k_cache[:, off:off + S] = k.to(k_cache.dtype)
            v_cache[:, off:off + S] = v.to(v_cache.dtype)
            new_cache = kv_cache
    else:  # decode
        k_cache, v_cache = kv_cache
        k_cache[:, cur_len:cur_len + S] = k.to(k_cache.dtype)
        v_cache[:, cur_len:cur_len + S] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, cur_len + S, scale=scale,
                             window=window, softcap=cfg.attn_softcap)
        new_cache = kv_cache

    o = o.to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    if tp:
        out = all_reduce(out, tp, layout.mesh)
    return out, new_cache


# ---------------------------------------------------------------------------
# Serving under a layout: d_model blocks, context-parallel decode
# ---------------------------------------------------------------------------


def d_blocks(layout, specs, name: str) -> bool:
    """Whether a block runs on d_model blocks: the activations' d split
    over ``embed`` axes, or weight ``name``'s d (its dim 0) left split."""
    return bool(layout.embed_axes or layout.tp_axes(specs[name][0]))


def contract_d(x, ws, w_dim: int, layout, w_entry):
    """``x`` (..., d_x) and weights ``ws`` whose dim ``w_dim`` is d_model,
    cut to one block of d_model: returns (x, ws, axes) such that the sum
    over ``axes`` of the products of the pieces is the whole product.
    ``x``'s d is split over the layout's ``embed_axes``, the weights'
    over the (kept) axes of their spec entry ``w_entry``; whichever is
    whole is cut to the other's block, entering through ``copy_to``
    over those axes (each rank reads another block of it)."""
    ex, ew = layout.embed_axes, layout.tp_axes(w_entry)
    mesh = layout.mesh
    if ex == ew:
        return x, ws, ex
    if not ex:
        return own_block(copy_to(x, ew, mesh), -1, ew, mesh), ws, ew
    if not ew:
        return x, [own_block(copy_to(w, ex, mesh), w_dim, ex, mesh)
                   for w in ws], ex
    raise ValueError(f"activations' d_model split over {ex}, a weight's "
                     f"over {ew}")


def out_d(h, w, w_dim: int, layout, w_entry):
    """The input ``h`` and the weight ``w`` (whose dim ``w_dim`` is the
    output d_model) of a down projection, the weight cut to the
    activations' block: returns (h, w, axes to all-gather the product
    over after its sum), the axes non-empty only where the weight's d is
    split and the activations' is whole.  ``h``, alike on the ranks
    whose output blocks differ, enters through ``copy_to`` over their
    axes (and a whole ``w`` cut to a block through ``copy_to`` too)."""
    ex, ew = layout.embed_axes, layout.tp_axes(w_entry)
    mesh = layout.mesh
    if ex == ew:
        return copy_to(h, ex, mesh), w, ()
    if not ew:
        return (copy_to(h, ex, mesh),
                own_block(copy_to(w, ex, mesh), w_dim, ex, mesh), ())
    if not ex:
        return copy_to(h, ew, mesh), w, ew
    raise ValueError(f"activations' d_model split over {ex}, a weight's "
                     f"output over {ew}")


def sum_parts(parts, axes, mesh, dim: int = -1):
    """The partial products ``parts`` summed over ``axes`` in one message
    (concatenated on ``dim``; ``all_reduce``: every rank then uses the
    sums alike)."""
    if not axes:
        return parts
    widths = [t.shape[dim] for t in parts]
    return list(torch.split(all_reduce(torch.cat(parts, dim=dim), axes,
                                       mesh), widths, dim=dim))


def write_block(buf, new, off: int, layout):
    """Write ``new`` (B, S, ...), the entries of global positions
    [off, off + S), into this rank's block ``buf`` (B, L, ...) of a cache
    whose ``max_len`` positions are split over ``layout.kv_axes``: only
    the positions the block holds."""
    L, S = buf.shape[1], new.shape[1]
    lo = (layout.mesh.block_index(layout.kv_axes) * L
          if layout.kv_axes else 0)
    a, b = max(off, lo), min(off + S, lo + L)
    if a < b:
        buf[:, a - lo:b - lo] = new[:, a - off:b - off].to(buf.dtype)


def decode_attention_block(q, k_cache, v_cache, cur_len, first: int, *,
                           scale, window=None, softcap=None):
    """``decode_attention`` over one block of a cache, the block's
    positions starting at global ``first``: returns the block's partial
    softmax, (m, l, o): the max score (B, Hkv, G, 1), the sum of the
    shifted exponentials and the unnormalised output (B, Hkv, G, 1, D),
    float32.  Positions past ``cur_len`` or outside the window weigh 0,
    so a block with none valid gives l = o = 0 (and m = ``_NEG_INF``)."""
    B, L, Hkv, D = k_cache.shape
    G = q.shape[2] // Hkv
    qg = q.float().reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    s = _softcap(s, softcap)
    pos = first + torch.arange(L, device=q.device)
    mask = (pos < cur_len)[None, :].expand(B, L)
    if window is not None:
        mask = mask & (pos >= cur_len - window)[None, :]
    mask = mask[:, None, None, None, :]
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    return m, p.sum(-1), torch.einsum("bhgqk,bkhd->bhgqd", p,
                                      v_cache.float())


def combine_blocks(m, l_, o, axes, mesh):
    """The softmax output from every rank's block of ``axes``: the max
    of the blocks' maxima, then one sum of each block's (o, l) rescaled
    to it.  (B, Hkv, G, 1, D) float32."""
    m_all = all_reduce_max(m, axes, mesh)
    a = torch.exp(m - m_all)              # 0 for a block with none valid
    ol = reduce(torch.cat([o * a[..., None], (l_ * a)[..., None]], -1),
                axes, mesh)
    return ol[..., :-1] / ol[..., -1:]


def _attention_serve(params, x, positions, cfg, spec, kv_cache, cur_len,
                     attn_impl, mode, layout, specs):
    """``attention_block``'s prefill and decode on this rank's rows, its
    block of d_model and its q heads (see the module's note); train mode
    runs prefill's attention without a cache, differentiably: ``x``
    enters the heads' ranks through ``copy_to``, and so do the kv
    weights where every rank holds every kv head."""
    S = x.shape[1]
    D = cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else D ** -0.5
    window = cfg.window if spec.attn_type == "local" else None
    mesh = layout.mesh
    h_ax = layout.tp_axes(specs["wq"][1])
    kv_ax = layout.tp_axes(specs["wk"][1])
    if kv_ax not in ((), h_ax):
        raise ValueError(f"q heads split over {h_ax}, kv heads over {kv_ax}")
    kv_whole = bool(h_ax) and not kv_ax
    names = ("wq", "wk", "wv")
    ws = [params[n] if n == "wq" or not kv_whole
          else copy_to(params[n], h_ax, mesh) for n in names]
    xu, ws, red = contract_d(copy_to(x, h_ax, mesh), ws, 0, layout,
                             specs["wq"][0])
    q, k, v = sum_parts([torch.einsum("bsd,dhk->bshk", xu, w) for w in ws],
                         red, mesh, dim=2)
    rope = apply_mrope if cfg.mrope else apply_rope
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    hq, block = q.shape[2], mesh.block_index(h_ax) if h_ax else 0
    if kv_cache is not None and kv_cache[0].shape[2] != k.shape[2]:
        raise ValueError(f"the cache block holds {kv_cache[0].shape[2]} kv "
                         f"heads, the projections {k.shape[2]}")
    off = 0 if cur_len is None else int(cur_len)
    if kv_cache is not None:
        write_block(kv_cache[0], k, off, layout)
        write_block(kv_cache[1], v, off, layout)
    if mode in ("prefill", "train"):
        kq, vq = _kv_of_heads(k, v, hq, cfg, block) if kv_whole else (k, v)
        if attn_impl == "reference":
            G = q.shape[2] // kq.shape[2]
            o = reference_attention(q, repeat_kv(kq, G), repeat_kv(vq, G),
                                    scale=scale, causal=True, window=window,
                                    softcap=cfg.attn_softcap)
        else:
            o = flash_attention(q.transpose(1, 2), kq.transpose(1, 2),
                                vq.transpose(1, 2), scale=scale, causal=True,
                                window=window,
                                softcap=cfg.attn_softcap).transpose(1, 2)
    else:
        k_c, v_c = kv_cache
        kv_s = layout.kv_axes
        if not kv_s:
            if kv_whole:
                k_c, v_c = _kv_of_heads(k_c, v_c, hq, cfg, block)
            o = decode_attention(q, k_c, v_c, off + S, scale=scale,
                                 window=window, softcap=cfg.attn_softcap)
        else:
            # every rank of the kv_seq group must work on the same q heads:
            # where the heads are split over one of its axes, all of them
            gather_q = bool(set(h_ax) & set(kv_s))
            if gather_q:
                if kv_ax:
                    raise ValueError(f"kv heads split over {kv_ax} and "
                                     f"positions over {kv_s}")
                q = gather(q, 2, h_ax, mesh)
            elif kv_whole:
                k_c, v_c = _kv_of_heads(k_c, v_c, hq, cfg, block)
            first = mesh.block_index(kv_s) * k_c.shape[1]
            m, l_, o = decode_attention_block(
                q, k_c, v_c, off + S, first, scale=scale, window=window,
                softcap=cfg.attn_softcap)
            o = combine_blocks(m, l_, o, kv_s, mesh)
            B_, Hkv_, G_ = o.shape[:3]
            o = o.permute(0, 3, 1, 2, 4).reshape(B_, 1, Hkv_ * G_, D)
            if gather_q:
                o = own_block(o, 2, h_ax, mesh)
    o, wo, g_ax = out_d(o.to(x.dtype), params["wo"], 2, layout,
                        specs["wo"][2])
    out = all_reduce(torch.einsum("bshk,hkd->bsd", o, wo), h_ax, mesh)
    return (all_gather(out, -1, g_ax, mesh) if g_ax else out), kv_cache


def _kv_of_heads(k, v, hq_local: int, cfg, block: int):
    """The kv heads that q heads ``block * hq_local + h`` (h < hq_local)
    of the global numbering read (kv head ``(block * hq_local + h) //
    G``), from all ``n_kv_heads``: a contiguous run when ``hq_local`` is
    a multiple of G, else one kv head per q head."""
    G = cfg.n_heads // cfg.n_kv_heads
    first = block * hq_local
    if hq_local % G == 0:
        return (k.narrow(2, first // G, hq_local // G),
                v.narrow(2, first // G, hq_local // G))
    idx = torch.arange(first, first + hq_local, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _act(cfg, h):
    """SiLU, or gelu tanh-approximated (as ``jax.nn.gelu``) when
    ``cfg.geglu``."""
    return F.gelu(h, approximate="tanh") if cfg.geglu else F.silu(h)


def mlp_block(params, x, cfg, layout=None, specs=None):
    """SwiGLU, or GeGLU when ``cfg.geglu``; with a ``layout``, d_ff split
    over the axes ``specs`` leave on ``w1``'s."""
    tp = () if layout is None else layout.tp_axes(specs["w1"][1])
    if layout is not None and d_blocks(layout, specs, "w1"):
        # on d_model blocks: partial products, one sum each way
        mesh = layout.mesh
        xu, ws, red = contract_d(copy_to(x, tp, mesh),
                                 [params["w1"], params["w3"]], 0, layout,
                                 specs["w1"][0])
        h1, h3 = sum_parts([torch.einsum("bsd,df->bsf", xu, w)
                             for w in ws], red, mesh)
        h, w2, g_ax = out_d(_act(cfg, h1) * h3, params["w2"], 1, layout,
                            specs["w2"][1])
        out = all_reduce(torch.einsum("bsf,fd->bsd", h, w2), tp, mesh)
        return all_gather(out, -1, g_ax, mesh) if g_ax else out
    if tp:
        x = copy_to(x, tp, layout.mesh)
    h = _act(cfg, torch.einsum("bsd,df->bsf", x, params["w1"]))
    h = h * torch.einsum("bsd,df->bsf", x, params["w3"])
    out = torch.einsum("bsf,fd->bsd", h, params["w2"])
    return all_reduce(out, tp, layout.mesh) if tp else out


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, gather/scatter dispatch with capacity dropping)
# ---------------------------------------------------------------------------

# When set to a list, moe_block appends each call's router output, a dict
# of ``probs`` (T, E) float32, ``top_e`` (T, K) and ``keep`` (T, K), the
# choice kept (not dropped at capacity), in (token, k) order: the routing
# that the tests and chip_smoke.py compare between two runs before their
# outputs.  Off (None) by default; the copies stay on the block's device.
ROUTES: Optional[list] = None


def moe_groups(cfg, layout, T: int) -> int:
    """The reference's ``_moe_groups``: dispatch groups aligned to the
    batch's shards, as many as the rule's batch axes of the mesh hold
    (halved while they do not divide the ``T`` tokens of the whole
    batch); 1 without a layout."""
    if layout is None:
        return 1
    ctx = layout.ctx
    axes = tuple(a for a in (ctx.rules.get("batch") or ())
                 if a in ctx.mesh.shape)
    g = ctx.axis_size(axes) if axes else 1
    while g > 1 and T % g:
        g //= 2
    return max(g, 1)


def moe_block(params, x, cfg, with_stats: bool = True, *, groups: int = 1,
              group_aux: bool = False, layout=None, specs=None):
    """Token-choice top-k MoE with the reference's dropping dispatch.
    x: (B, S, d).  Returns (out (B, S, d), stats): stats ``aux_loss``
    (the Switch load-balance loss, float32 scalar) and ``expert_load``
    ((E,) float32, the choices each expert kept), or None unless
    ``with_stats`` (serving reads neither).

    The tokens split into ``groups`` contiguous dispatch groups of ``Tg``
    tokens.  In a group the (token, k) choices are sorted by expert with a
    stable sort, so within an expert they keep token order; an expert
    keeps its first ``C = max(1, int(Tg * K * capacity_factor) // E)``
    and drops the rest to a scratch slot.  At decode (T = B tokens, one
    group) C is 1.  ``aux_loss`` is the reference's, over all tokens, or
    with ``group_aux`` the mean of each group's own (the expert-parallel
    block's definition).

    With a ``layout`` the tokens are this rank's rows, which hold whole
    groups of the reference's ``moe_groups`` count over the whole batch;
    ``aux_loss`` and ``expert_load`` are summed over the batch's ranks."""
    m = cfg.moe
    if layout is None:
        return _moe(params, x, cfg, with_stats, groups, group_aux)
    T = x.shape[0] * x.shape[1]
    gg, nb = moe_groups(cfg, layout, T * layout.n_blocks), layout.n_blocks
    if gg % nb:
        raise NotImplementedError(
            f"{gg} dispatch groups over {nb} batch blocks: a group across "
            "ranks")
    t_e = layout.tp_axes(specs["w1"][0])
    t_f = layout.tp_axes(specs["w1"][2])
    mesh = layout.mesh
    e_loc = m.n_experts // layout.ctx.axis_size(t_e)
    experts = (mesh.block_index(t_e) * e_loc if t_e else 0, e_loc)
    tp = tuple(a for a in mesh.axes if a in t_e + t_f)
    t_sh = layout.tp_axes(specs["shared_w1"][2]) if m.n_shared else tp
    if t_sh not in ((), tp):
        raise ValueError(f"shared experts split over {t_sh}, experts "
                         f"over {tp}")
    dsplit = None
    if layout.embed_axes or layout.tp_axes(specs["w1"][1]):
        dsplit = (layout, specs)
    return _moe(params, x, cfg, with_stats, gg // nb, group_aux=False,
                experts=experts, tp=tp, t_shared=t_sh, mesh=mesh,
                batch_axes=layout.batch_axes, dsplit=dsplit)


def moe_block_ep(params, x, cfg, layout, specs, with_stats: bool = True):
    """The reference's ``moe_block_ep`` (see the module's note) on this
    rank's rows; the dense ``moe_block`` where the reference falls back to
    it.  Its experts take whole d_model rows, as the reference's
    ``shard_map`` takes them: serving on d_model blocks, the rows are
    gathered over the ``embed`` axes and the router's and experts' d
    dims over theirs (parameter gathers), and the output cut back to the
    rank's block."""
    m = cfg.moe
    ctx, mesh = layout.ctx, layout.mesh
    E = m.n_experts
    if "model" not in mesh.shape or E % mesh.shape["model"] or m.n_shared:
        return moe_block(params, x, cfg, with_stats, layout=layout,
                         specs=specs)
    B = x.shape[0] * layout.n_blocks
    ep_axes = tuple(a for a in (ctx.rules.get("batch") or ())
                    if a in mesh.shape and a != "model")
    if B % max(1, ctx.axis_size(ep_axes)):
        ep_axes = ()
    if ep_axes != layout.batch_axes \
            or entry_axes(specs["w1"][0]) != ("model",) \
            or layout.tp_axes(specs["w1"][2]):
        raise NotImplementedError(
            f"moe_impl='ep' with the batch split over {layout.batch_axes} "
            f"(the block routes over {ep_axes}) and the experts laid out "
            f"as {specs['w1']}: only the experts split over 'model' alone "
            "and the rows over the rule's other batch axes")
    whole = dict(params)
    for k, dim in (("router", 0), ("w1", 1), ("w3", 1), ("w2", 2)):
        ax = layout.tp_axes(specs[k][dim])
        if ax:
            whole[k] = all_gather(params[k], dim, ax, mesh, param=True)
    ex = layout.embed_axes
    e_loc = E // mesh.shape["model"]
    out, stats = _moe(whole, all_gather(x, -1, ex, mesh) if ex else x,
                      cfg, with_stats, 1, group_aux=True,
                      experts=(mesh.axis_index("model") * e_loc, e_loc),
                      tp=("model",), t_shared=(), mesh=mesh,
                      batch_axes=layout.batch_axes, ep=True)
    return (own_block(copy_to(out, ex, mesh), -1, ex, mesh) if ex
            else out), stats


def _glu(cfg, xe, params, names, dsplit, mesh):
    """The gated first product of experts stacked on dim 0 (``xe``
    (E, C, d)) and their down matrix: returns (act(xe w1) * xe w3, w2,
    axes to gather the down product's d over).  With ``dsplit`` the
    first products are partial over d_model blocks, summed in one
    message, and w2 is cut to the activations' block (``out_d``)."""
    w1, w3, w2 = (params[n] for n in names)
    if dsplit is None:
        h = _act(cfg, torch.einsum("ecd,edf->ecf", xe, w1))
        return h * torch.einsum("ecd,edf->ecf", xe, w3), w2, ()
    lay, sp = dsplit
    xu, ws, red = contract_d(xe, [w1, w3], 1, lay, sp[names[0]][1])
    h1, h3 = sum_parts([torch.einsum("ecd,edf->ecf", xu, w) for w in ws],
                        red, mesh)
    return out_d(_act(cfg, h1) * h3, w2, 2, lay, sp[names[2]][2])


def _moe(params, x, cfg, with_stats, groups, group_aux, *, experts=None,
         tp=(), t_shared=(), mesh=None, batch_axes=(), ep=False,
         dsplit=None):
    """The dispatch of ``moe_block``.  ``experts`` = (first, count): the
    experts this rank computes (all by default), their weights' local
    blocks, their d_ff split over the rest of ``tp``; the output is summed
    over ``tp`` (and the shared experts' over ``t_shared``).  Stats are
    summed over ``batch_axes`` (``ep``: the aux loss averaged over them,
    the load gathered from each expert slice over 'model').
    ``dsplit`` = (layout, specs) when serving on d_model blocks: ``x``
    is this rank's block, the router's logits and the experts' first
    products are summed over the d axes before use (``contract_d``)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    G = groups
    Tg = T // G
    C = max(1, int(Tg * K * m.capacity_factor) // E)
    e0, e_loc = experts or (0, E)
    dev = x.device

    xt = x.reshape(T, d)
    if dsplit is None:
        logits = torch.matmul(xt, params["router"]).float()
    else:
        lay, sp = dsplit
        xu, (wr,), red = contract_d(xt, [params["router"]], 0, lay,
                                    sp["router"][0])
        logits = all_reduce(torch.matmul(xu, wr), red, mesh).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)                 # (T, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # dispatch: in each group sort the (token, k) choices by expert,
    # stably; slots run expert-major over (expert, group, position)
    e_sorted, perm = torch.sort(top_e.reshape(G, Tg * K), dim=-1,
                                stable=True)
    w_sorted = torch.gather(top_w.reshape(G, Tg * K).to(x.dtype), 1, perm)
    first = torch.arange(G, device=dev)[:, None]
    tok_sorted = perm // K + first * Tg                          # (G, Tg*K)
    group_start = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev, dtype=e_sorted.dtype)
        .expand(G, E).contiguous())
    pos_in_e = (torch.arange(Tg * K, device=dev)[None, :]
                - torch.gather(group_start, 1, e_sorted))
    keep = pos_in_e < C
    e_local = e_sorted - e0
    mine = keep & (e_local >= 0) & (e_local < e_loc)
    n_slots = e_loc * G * C
    slot = torch.where(mine, e_local * (G * C) + first * C + pos_in_e,
                       torch.full_like(e_sorted, n_slots))       # drop
    slot, tok_sorted = slot.reshape(-1), tok_sorted.reshape(-1)

    xd = copy_to(xt, tp, mesh) if tp else xt
    xe = torch.zeros((n_slots + 1, d), dtype=x.dtype, device=dev)
    xe[slot] = xd[tok_sorted]
    xe = xe[:n_slots].reshape(e_loc, G * C, d)
    h, w2, g_ax = _glu(cfg, xe, params, ("w1", "w3", "w2"), dsplit, mesh)
    ye = torch.einsum("ecf,efd->ecd", h, w2)
    d = ye.shape[-1]
    ye = ye.reshape(n_slots, d)

    picked = ye[torch.clamp(slot, max=n_slots - 1)]
    picked = torch.where(mine.reshape(-1)[:, None], picked,
                         torch.zeros((), dtype=x.dtype, device=dev))
    # the routing weights, alike on every rank, scale this rank's experts
    # and, on d_model blocks, its block of their outputs: their gradient
    # is summed over both
    w_ax = tp
    if dsplit is not None:
        lay, sp = dsplit
        d_ax = lay.embed_axes or lay.tp_axes(sp["w2"][2])
        w_ax = tuple(a for a in mesh.axes if a in tp + d_ax)
    if w_ax:
        w_sorted = copy_to(w_sorted, w_ax, mesh)
    # the weighted scatter-add: each choice lands in its own (token, k) row
    # (perm is a permutation, so no two additions race on the card), then
    # a token's K rows are summed in k order: the same bits every run
    flat_perm = (perm + first * (Tg * K)).reshape(-1)
    out = torch.zeros((T * K, d), dtype=x.dtype, device=dev).index_add_(
        0, flat_perm, picked * w_sorted.reshape(-1)[:, None]
    ).reshape(T, K, d).sum(1)

    shared = None
    if m.n_shared:
        xs = copy_to(xt, t_shared, mesh) if t_shared else xt
        if dsplit is None:
            hs = _act(cfg, torch.einsum("td,sdf->tsf", xs,
                                        params["shared_w1"]))
            hs = hs * torch.einsum("td,sdf->tsf", xs, params["shared_w3"])
            shared = torch.einsum("tsf,sfd->td", hs, params["shared_w2"])
        else:
            hs, w2s, _ = _glu(cfg, xs[None].expand(m.n_shared, -1, -1),
                              params, ("shared_w1", "shared_w3",
                                       "shared_w2"), dsplit, mesh)
            shared = torch.einsum("stf,sfd->td", hs, w2s)
        if t_shared or not tp:
            out, shared = out + shared, None
    if tp:
        out = all_reduce(out, tp, mesh)
    if shared is not None:
        out = out + shared
    if dsplit is not None and g_ax:
        out = all_gather(out, -1, g_ax, mesh)

    if ROUTES is not None:
        kept = torch.empty_like(keep.reshape(-1))
        kept[flat_perm] = keep.reshape(-1)
        ROUTES.append({"probs": probs, "top_e": top_e,
                       "keep": kept.reshape(T, K)})
    if not with_stats:
        return out.reshape(B, S, d), None
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    one_hot = F.one_hot(top_e[:, 0], E).float()
    if batch_axes and not ep:
        n = T * mesh.size(batch_axes)
        f_e = reduce(one_hot.sum(0), batch_axes, mesh) / n
        p_e = all_reduce(probs.sum(0), batch_axes, mesh) / n
        aux_loss = E * torch.sum(f_e * p_e)
    elif group_aux and G > 1:
        aux_loss = torch.mean(E * torch.sum(
            one_hot.reshape(G, Tg, E).mean(1)
            * probs.reshape(G, Tg, E).mean(1), dim=-1))
    else:
        aux_loss = E * torch.sum(one_hot.mean(0) * probs.mean(0))
    if ep and batch_axes:
        aux_loss = all_reduce(aux_loss, batch_axes, mesh) / mesh.size(
            batch_axes)
    if ep:      # this rank's experts' slice, gathered over 'model'
        idx, counts, n_e = e_local.clamp(0, e_loc - 1), mine, e_loc
    else:
        idx, counts, n_e = e_sorted, keep, E
    load = torch.zeros((n_e,), dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), counts.reshape(-1).float())
    if ep:
        load = gather(load, 0, ("model",), mesh)
    if batch_axes:
        load = reduce(load, batch_axes, mesh)
    return out.reshape(B, S, d), {"aux_loss": aux_loss, "expert_load": load}
