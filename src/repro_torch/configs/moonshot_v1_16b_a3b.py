"""moonshot-v1-16b-a3b — fine-grained MoE (kimi/moonlight).

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 vocab=163840, MoE 64e top-6.  DeepSeek-style fine-grained experts
(small d_ff_expert, high top-k).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
