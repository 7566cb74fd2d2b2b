"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 ratio.

Source: arXiv:2402.19427 (Griffin); 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000. Pattern (rglru, rglru, local) — "1:2" attention:
recurrent ratio. O(1) recurrent state + windowed attention =>
long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    mlp_kind="geglu",
    ssm=SSMConfig(d_rnn=4096, conv_width=4),
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
    sub_quadratic=True,
    source="arXiv:2402.19427",
)
