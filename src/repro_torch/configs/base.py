"""Config dataclasses of the port: a copy of the reference's
``configs/base.py`` (plain data, no framework import).

Every assigned architecture is expressed as a ``ModelConfig`` built from a
repeating ``pattern`` of ``LayerSpec``s (the *super-block*).  The model stack
is ``pattern * (n_layers // len(pattern))``; parameters are stacked on a
leading layer dimension per pattern position, and the model code loops over
super-blocks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Top-k token-choice MoE (GShard-style dropping dispatch)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight (synced via regc.reduce)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer config (arXiv:2405.21060)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # SSD "P"; n_ssm_heads = expand*d_model // head_dim
    chunk: int = 256            # SSD chunk length (state-passing granularity)
    n_groups: int = 1           # B/C groups (GVA-style)


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating super-block."""

    kind: str = "attn"          # 'attn' | 'ssm'
    attn_type: str = "global"   # 'global' | 'local'   (only for kind='attn')
    mlp: str = "dense"          # 'dense' | 'moe' | 'none'


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'audio' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    head_dim: int
    d_ff: int                   # dense-MLP hidden dim (0 if no MLP)
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # attention details
    rope_theta: float = 10_000.0
    window: Optional[int] = None        # sliding-window size for 'local' layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    mrope: bool = False                  # multimodal 3D RoPE (qwen2-vl); position
    #                                      ids (3, B, S) are a model *input*.

    # misc
    norm_eps: float = 1e-5
    use_post_norm: bool = False          # gemma2: post-block RMSNorm as well
    geglu: bool = False                  # gemma2 GeGLU; default SwiGLU
    tie_embeddings: bool = False
    input_mode: str = "tokens"           # 'tokens' | 'embeds' (audio/vlm stubs)
    sub_quadratic: bool = False          # True iff long_500k decode is runnable

    # citation / provenance (goes into DESIGN.md + config docstrings)
    source: str = ""

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}"
        )
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0

    # -- derived ----------------------------------------------------------
    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed top-k + shared experts)."""
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model  # lm head
    per_period = 0
    for spec in cfg.pattern:
        per_period += cfg.d_model  # input norm
        if cfg.use_post_norm:
            per_period += cfg.d_model
        if spec.kind == "attn":
            per_period += cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
            per_period += cfg.q_dim * cfg.d_model
        elif spec.kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            n_h = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            per_period += cfg.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
            per_period += conv_dim * s.d_conv + conv_dim  # depthwise conv + bias
            per_period += n_h * 2              # A_log, D
            per_period += n_h                  # dt_bias
            per_period += d_in                 # gate norm
            per_period += d_in * cfg.d_model   # out proj
        if spec.mlp == "dense":
            per_period += cfg.d_model  # post-attn norm
            if cfg.use_post_norm:
                per_period += cfg.d_model
            per_period += 3 * cfg.d_model * cfg.d_ff
        elif spec.mlp == "moe":
            m = cfg.moe
            per_period += cfg.d_model  # post-attn norm
            if cfg.use_post_norm:
                per_period += cfg.d_model
            per_period += cfg.d_model * m.n_experts  # router
            n_e = (m.top_k + m.n_shared) if active_only else (m.n_experts + m.n_shared)
            per_period += n_e * 3 * cfg.d_model * m.d_ff_expert
    total += per_period * cfg.n_superblocks
    total += cfg.d_model  # final norm
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned; LM shapes are seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which assigned shapes apply to this arch (long_500k needs sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return tuple(names)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig, *, n_periods: int = 1) -> ModelConfig:
    """Shrink a config to smoke-test scale while preserving its *structure*
    (same pattern, same family, same feature flags)."""
    small_moe = None
    if cfg.moe is not None:
        small_moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
        )
    small_ssm = None
    if cfg.ssm is not None:
        small_ssm = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=32,
        )
    n_heads = 4 if cfg.n_heads else 0
    n_kv = 0
    if cfg.n_heads:
        n_kv = 1 if cfg.n_kv_heads == 1 else (4 if cfg.n_kv_heads == cfg.n_heads else 2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=len(cfg.pattern) * n_periods,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        moe=small_moe,
        ssm=small_ssm,
        window=min(cfg.window, 16) if cfg.window else None,
    )
