"""granite-20b — llama-arch code model with MQA (kv=1).

[arXiv:2405.04324; hf]  52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152.  ``long_500k`` skipped (pure full attention).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    rope_theta=10_000.0,
    source="arXiv:2405.04324",
)
