"""whisper-small [audio] — encoder-decoder, conv/mel frontend STUBBED.

Source: arXiv:2212.04356; 12L (decoder) d_model=768 12H d_ff=3072
vocab=51865; 12-layer bidirectional encoder over 1500 frame embeddings.
The mel-spectrogram + conv feature extractor is a stub per the assignment:
``input_specs`` provides precomputed (B, 1500, 768) frame embeddings.

Backbone deviation (noted in DESIGN.md): RoPE instead of learned absolute
positions. Decode shapes lower the DECODER step (self-KV cache of the
assigned seq_len + fixed cross-KV); full attention => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, EncoderConfig, FrontendConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=("crossdec",),
    mlp_kind="gelu",
    encoder=EncoderConfig(n_layers=12, n_ctx=1500, d_model=768),
    frontend=FrontendConfig(kind="audio"),
    qkv_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    sub_quadratic=False,
    source="arXiv:2212.04356",
)
