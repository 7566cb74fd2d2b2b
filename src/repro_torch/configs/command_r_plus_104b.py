"""command-r-plus-104b [dense] — GQA, no-bias.

Source: hf:CohereForAI/c4ai-command-r-v01 (family card); 64L d_model=12288
96H (GQA kv=8) d_ff=33792 vocab=256000. Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    layer_pattern=("global",),
    mlp_kind="swiglu",
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    sub_quadratic=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
