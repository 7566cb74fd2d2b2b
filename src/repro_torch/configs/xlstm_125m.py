"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.

Source: arXiv:2405.04517; 12L d_model=768 4H d_ff=0 (blocks carry their
own projections) vocab=50304. Pattern 3x mLSTM : 1x sLSTM (xLSTM[.:1]
style ratio). Recurrent => O(1) decode state, long_500k-eligible.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm=SSMConfig(n_heads=4, conv_width=4),
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.04517",
)
