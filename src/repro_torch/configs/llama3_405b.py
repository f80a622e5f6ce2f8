"""llama3-405b — dense GQA, 128k vocab.

[arXiv:2407.21783; unverified]  126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256.  rope_theta=500000.  ``long_500k`` skipped (pure
full attention; see DESIGN.md §5).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
