"""internvl2-1b [vlm] — InternViT frontend STUBBED + Qwen2-0.5B LM backbone.

Source: arXiv:2404.16821; LM backbone 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151655. The InternViT vision encoder + MLP projector is a
stub per the assignment: ``input_specs`` provides 256 precomputed patch
embeddings of shape (B, 256, 896) that are prepended to the token stream.
Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, FrontendConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    layer_pattern=("global",),
    mlp_kind="swiglu",
    frontend=FrontendConfig(kind="vision", n_prefix=256),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    sub_quadratic=False,
    source="arXiv:2404.16821",
)
