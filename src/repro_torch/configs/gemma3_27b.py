"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

Source: hf:google/gemma-3-1b-pt (family card); 62L d_model=5376 32H
(GQA kv=16) d_ff=21504 vocab=262144. head_dim=128 per the Gemma 3 report.
Sliding-window (1024) local layers make it long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("local",) * 5 + ("global",),
    window=1024,
    mlp_kind="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt",
)
