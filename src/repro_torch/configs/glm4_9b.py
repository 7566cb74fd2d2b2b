"""glm4-9b [dense] — RoPE, GQA kv=2.

Source: hf:THUDM/glm-4-9b; 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552. GLM-4 uses QKV bias; pure full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    layer_pattern=("global",),
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    qkv_bias=True,
    sub_quadratic=False,
    source="hf:THUDM/glm-4-9b",
)
