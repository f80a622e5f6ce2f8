"""qwen2-vl-72b — VLM backbone with M-RoPE.

[arXiv:2409.12191; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  M-RoPE (temporal/height/width rotary sections); the vision
frontend (ViT, dynamic resolution) is a STUB: ``input_specs()`` provides
precomputed patch embeddings plus (3, B, S) multimodal position ids.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    rope_theta=1_000_000.0,
    mrope=True,
    input_mode="embeds",
    source="arXiv:2409.12191",
)
