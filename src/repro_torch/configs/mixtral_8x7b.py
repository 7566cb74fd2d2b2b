"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

Source: arXiv:2401.04088; 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096 => long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    layer_pattern=("local",),
    window=4096,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    sub_quadratic=True,
    source="arXiv:2401.04088",
)
