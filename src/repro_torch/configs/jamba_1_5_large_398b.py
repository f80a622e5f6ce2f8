"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887 / 2408.12570; hf]  72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2.  Super-block of 8 layers with one
attention layer (index 4, as in the Jamba paper) and MoE on every other
layer (odd indices).  Sub-quadratic: only 9/72 layers carry a KV cache, so
the ``long_500k`` decode shape is runnable.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_PATTERN = tuple(
    LayerSpec(
        kind="attn" if i == 4 else "ssm",
        attn_type="global",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    rope_theta=10_000.0,
    sub_quadratic=True,
    source="arXiv:2403.19887",
)
