"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144
vocab=2048.  The EnCodec frontend (RVQ codebooks, delay pattern) is a STUB:
``input_specs()`` provides precomputed frame embeddings (input_mode='embeds').
The backbone is the standard transformer decoder the paper trains.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    rope_theta=10_000.0,
    input_mode="embeds",
    source="arXiv:2306.05284",
)
