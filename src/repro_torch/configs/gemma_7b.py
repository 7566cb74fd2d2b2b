"""gemma-7b [dense] — GeGLU, head_dim=256.

Source: arXiv:2403.08295; 28L d_model=3072 16H (kv=16; MQA is on the 2b)
d_ff=24576 vocab=256000. Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    layer_pattern=("global",),
    mlp_kind="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
    sub_quadratic=False,
    source="arXiv:2403.08295",
)
