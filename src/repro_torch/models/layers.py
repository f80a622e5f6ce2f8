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
the training loss reads.  The expert-parallel ``moe_block_ep`` needs a
device mesh across processes and waits for ROADMAP item 13e.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

_NEG_INF = -1e30
ATTN_IMPLS = ("blocked", "reference")


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
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
                    mode: str = "train"):
    """Full attention layer. x: (B, S, d).

    mode='train'   : no cache I/O, causal attention.
    mode='prefill' : kv_cache = (k_buf, v_buf) sized (B, max_len, Hkv, D);
                     writes the S fresh KV at cur_len, attends within the
                     prompt, returns the buffers.
    mode='decode'  : S==1; writes at cur_len, attends against the cache.

    The cache buffers are written in place (the reference returns updated
    copies): the returned cache is the (k_buf, v_buf) passed in."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}; allowed: {ATTN_IMPLS}")
    S = x.shape[1]
    D = cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else D ** -0.5
    window = cfg.window if spec.attn_type == "local" else None

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])          # (B,S,Hq,D)
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])          # (B,S,Hkv,D)
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    rope = apply_mrope if cfg.mrope else apply_rope
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode in ("train", "prefill"):
        if attn_impl == "reference":
            G = cfg.n_heads // cfg.n_kv_heads
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
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _act(cfg, h):
    """SiLU, or gelu tanh-approximated (as ``jax.nn.gelu``) when
    ``cfg.geglu``."""
    return F.gelu(h, approximate="tanh") if cfg.geglu else F.silu(h)


def mlp_block(params, x, cfg):
    """SwiGLU, or GeGLU when ``cfg.geglu``."""
    h = _act(cfg, torch.einsum("bsd,df->bsf", x, params["w1"]))
    h = h * torch.einsum("bsd,df->bsf", x, params["w3"])
    return torch.einsum("bsf,fd->bsd", h, params["w2"])


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, gather/scatter dispatch with capacity dropping)
# ---------------------------------------------------------------------------

# When set to a list, moe_block appends each call's router output, a dict
# of ``probs`` (T, E) float32, ``top_e`` (T, K) and ``keep`` (T, K), the
# choice kept (not dropped at capacity), in (token, k) order: the routing
# that the tests and chip_smoke.py compare between two runs before their
# outputs.  Off (None) by default; the copies stay on the block's device.
ROUTES: Optional[list] = None


def moe_block(params, x, cfg, with_stats: bool = True):
    """Token-choice top-k MoE with the reference's dropping dispatch in
    one group.  x: (B, S, d).  Returns (out (B, S, d), stats): stats
    ``aux_loss`` (the Switch load-balance loss, float32 scalar) and
    ``expert_load`` ((E,) float32, the choices each expert kept), or
    None unless ``with_stats`` (serving reads neither).

    The (token, k) choices are sorted by expert with a stable sort, so
    within an expert they keep token order; an expert keeps its first
    ``C = max(1, int(T * K * capacity_factor) // E)`` and drops the rest
    to a scratch slot.  At decode (T = B tokens) C is 1."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = max(1, int(T * K * m.capacity_factor) // E)

    xt = x.reshape(T, d)
    logits = torch.matmul(xt, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)                 # (T, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # dispatch: sort the (token, k) choices by expert, stably
    e_sorted, perm = torch.sort(top_e.reshape(T * K), stable=True)
    w_sorted = top_w.reshape(T * K).to(x.dtype)[perm]
    tok_sorted = perm // K                                      # (T*K,)
    group_start = torch.searchsorted(
        e_sorted, torch.arange(E, device=x.device, dtype=e_sorted.dtype))
    pos_in_e = torch.arange(T * K, device=x.device) - group_start[e_sorted]
    keep = pos_in_e < C
    slot = torch.where(keep, e_sorted * C + pos_in_e,
                       torch.full_like(e_sorted, E * C))        # drop

    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xe[slot] = xt[tok_sorted]
    xe = xe[:E * C].reshape(E, C, d)
    h = _act(cfg, torch.einsum("ecd,edf->ecf", xe, params["w1"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, params["w3"])
    ye = torch.einsum("ecf,efd->ecd", h, params["w2"]).reshape(E * C, d)

    picked = ye[torch.clamp(slot, max=E * C - 1)]
    picked = torch.where(keep[:, None], picked, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    # the weighted scatter-add: each choice lands in its own (token, k) row
    # (perm is a permutation, so no two additions race on the card), then
    # a token's K rows are summed in k order: the same bits every run
    out = torch.zeros((T * K, d), dtype=x.dtype, device=x.device).index_add_(
        0, perm, picked * w_sorted[:, None]).reshape(T, K, d).sum(1)

    if m.n_shared:
        hs = _act(cfg, torch.einsum("td,sdf->tsf", xt, params["shared_w1"]))
        hs = hs * torch.einsum("td,sdf->tsf", xt, params["shared_w3"])
        out = out + torch.einsum("tsf,sfd->td", hs, params["shared_w2"])

    if ROUTES is not None:
        kept = torch.empty_like(keep)
        kept[perm] = keep
        ROUTES.append({"probs": probs, "top_e": top_e,
                       "keep": kept.reshape(T, K)})
    if not with_stats:
        return out.reshape(B, S, d), None
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    f_e = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux_loss = E * torch.sum(f_e * probs.mean(0))
    load = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, e_sorted, keep.float())
    return out.reshape(B, S, d), {"aux_loss": aux_loss, "expert_load": load}
