"""A dense GQA decoder (InternLM2): the port's config from the file, and
its model FLOPs.

Model FLOPs are the matrix products a step or a request needs, two per
multiply-add, without the rerun of a remat: the projections and the MLP
(the body's weights), the LM head, and causal attention counted as
2 S^2 d_attn a sequence and layer forward (q.k and p.v over the S^2 / 2
pairs), where d_attn = H D.  Training is three times the forward."""
from __future__ import annotations


def program_config(conf):
    from repro_torch.configs.base import LayerSpec, ModelConfig
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return ModelConfig(
        name=conf["name"], family="dense",
        n_layers=conf["num_hidden_layers"], d_model=d, n_heads=H,
        n_kv_heads=conf["num_key_value_heads"], head_dim=d // H,
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        pattern=(LayerSpec(kind="attn", mlp="dense"),),
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        source=conf["source"])


def _sizes(conf):
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    D = d // H
    Hkv = conf["num_key_value_heads"]
    body = (d * (H + 2 * Hkv) * D + H * D * d
            + 3 * d * conf["intermediate_size"])
    return d, H * D, body * conf["num_hidden_layers"], conf["vocab_size"]


def train_step_flops(conf, batch: int, seq: int) -> float:
    d, d_attn, body, V = _sizes(conf)
    L = conf["num_hidden_layers"]
    return 3.0 * batch * (2 * (body + d * V) * seq
                          + 2 * seq * seq * d_attn * L)


def prefill_flops(conf, n: int) -> float:
    """A prompt of ``n`` real tokens: every position through the body,
    causal attention over them, the LM head once."""
    d, d_attn, body, V = _sizes(conf)
    L = conf["num_hidden_layers"]
    return 2.0 * body * n + 2.0 * n * n * d_attn * L + 2.0 * d * V


def decode_flops(conf, keys: int) -> float:
    """One decode step whose token attends to ``keys`` real positions."""
    d, d_attn, body, V = _sizes(conf)
    L = conf["num_hidden_layers"]
    return 2.0 * body + 4.0 * keys * d_attn * L + 2.0 * d * V
