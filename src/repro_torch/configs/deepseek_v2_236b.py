"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

Source: arXiv:2405.04434; 60L d_model=5120 128H d_ff=1536 (routed expert
width) vocab=102400. MLA compresses the KV cache but attention is still
full => long_500k skipped (cache *would* fit; see DESIGN.md §6).

Deviation from source model: DeepSeek-V2's first layer is a dense FFN
(d_ff=12288); we use MoE in every layer for stacking uniformity (noted).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,              # qk_nope(128)+qk_rope(64); v_head_dim=128
    d_ff=1536,
    vocab_size=102400,
    layer_pattern=("global",),
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared=2, d_ff_shared=1536),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    rope_theta=10_000.0,
    tie_embeddings=False,
    sub_quadratic=False,
    source="arXiv:2405.04434",
)
