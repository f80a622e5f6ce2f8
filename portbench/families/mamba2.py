"""Mamba-2: the port's config from the file, and its model FLOPs.

Model FLOPs are the matrix products a request needs, two per
multiply-add: the in and out projections, the LM head, and the SSD's
products counted from its shapes, chunk by chunk of ``chunk_size``
positions as the algorithm needs them: C.B^T over a chunk's causal pairs
once per B/C group, the scores times x and each chunk's state per head,
and the earlier chunks' state read by C.  A decode step's state update
and read are 2 H P N each.  The depthwise convolution, the norms and
the gates are not matrix products and are not counted."""
from __future__ import annotations


def program_config(conf):
    from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
    s = conf["ssm_cfg"]
    return ModelConfig(
        name=conf["name"], family="ssm", n_layers=conf["n_layer"],
        d_model=conf["d_model"], n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=conf["vocab_size"],
        pattern=(LayerSpec(kind="ssm", mlp="none"),),
        ssm=SSMConfig(d_state=s["d_state"], d_conv=s["d_conv"],
                      expand=s["expand"], head_dim=s["headdim"],
                      chunk=s["chunk_size"], n_groups=s["ngroups"]),
        norm_eps=float(conf["norm_epsilon"]),
        tie_embeddings=bool(conf["tie_embeddings"]),
        sub_quadratic=True, source=conf["source"])


def _sizes(conf):
    s = conf["ssm_cfg"]
    d = conf["d_model"]
    d_in = s["expand"] * d
    H, P, N, G = d_in // s["headdim"], s["headdim"], s["d_state"], \
        s["ngroups"]
    proj = d * (2 * d_in + 2 * G * N + H) + d_in * d
    return d, H, P, N, G, proj


def ssd_flops(conf, n: int) -> float:
    d, H, P, N, G, _ = _sizes(conf)
    Q = conf["ssm_cfg"]["chunk_size"]
    total = 0.0
    for a in range(0, n, Q):
        q = min(Q, n - a)
        pairs = q * (q + 1) // 2
        total += G * pairs * 2 * N + H * (pairs * 2 * P + 2 * q * P * N)
        if a:
            total += 2 * q * H * P * N
    return total


def prefill_flops(conf, n: int) -> float:
    d, H, P, N, G, proj = _sizes(conf)
    L = conf["n_layer"]
    return L * (2.0 * proj * n + ssd_flops(conf, n)) \
        + 2.0 * d * conf["vocab_size"]


def decode_flops(conf, keys: int) -> float:
    d, H, P, N, G, proj = _sizes(conf)
    L = conf["n_layer"]
    return L * (2.0 * proj + 4.0 * H * P * N) + 2.0 * d * conf["vocab_size"]
