"""mamba2-2.7b — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  64L d_model=2560 (attn-free) d_ff=0
vocab=50280, ssm_state=128.  d_inner = 2*d_model = 5120, SSD head_dim=64
(80 heads), conv4, chunk 256.  Sub-quadratic by construction: ``long_500k``
decode runs with O(1)-per-token recurrent state.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(kind="ssm", mlp="none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
    source="arXiv:2405.21060",
)
