"""gemma2-27b — dense, alternating local/global attention, logit softcaps.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  head_dim=128 (q_dim 4096 != d_model — separate o-proj),
query scale (d_model/n_heads)^-1/2 = 144^-1/2, sliding window 4096 on local
layers, attn softcap 50, final softcap 30, GeGLU, pre+post RMSNorm.

``long_500k`` is SKIPPED for this arch: half the layers are *global* full
attention, so 512k-token decode is not sub-quadratic (see DESIGN.md §5).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_PATTERN = (
    LayerSpec(kind="attn", attn_type="local", mlp="dense"),
    LayerSpec(kind="attn", attn_type="global", mlp="dense"),
)

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=_PATTERN,
    rope_theta=10_000.0,
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=144.0 ** -0.5,
    geglu=True,
    use_post_norm=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
