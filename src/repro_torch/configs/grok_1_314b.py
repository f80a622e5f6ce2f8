"""grok-1-314b — 8-expert top-2 MoE.

[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    rope_theta=10_000.0,
    source="hf:xai-org/grok-1",
)
