"""Model configuration dataclasses — a copy of the JAX package's
framework-free ``repro/configs/base.py`` (``ModelConfig``, its
sub-dataclasses, ``LAYER_KINDS`` and ``reduced``), so the port builds the
same configurations without importing ``repro``; also ``INPUT_SHAPES``,
``param_count`` (counted on the ``meta`` device where the JAX package
uses ``jax.eval_shape``) and ``active_param_count``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# Layer kinds usable in ``layer_pattern`` (the repeating unit):
#   "global"  - full causal self-attention
#   "local"   - sliding-window causal self-attention (cfg.window)
#   "rglru"   - RG-LRU recurrent block (Griffin / RecurrentGemma)
#   "mlstm"   - xLSTM matrix-memory block
#   "slstm"   - xLSTM scalar-memory block
#   "crossdec"- decoder block with self-attn + cross-attn (whisper decoder)
LAYER_KINDS = ("global", "local", "rglru", "mlstm", "slstm", "crossdec")

ATTN_KINDS = ("global", "local", "crossdec")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts
    d_ff_shared: int = 0       # d_ff of EACH shared expert
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_rnn: int = 0             # recurrent width (rglru); 0 => d_model
    conv_width: int = 4
    n_heads: int = 4           # xLSTM heads


@dataclass(frozen=True)
class EncoderConfig:
    """Bidirectional encoder (whisper). Frontend embeddings are a stub."""
    n_layers: int
    n_ctx: int                 # e.g. 1500 mel frames after conv stride
    d_model: int


@dataclass(frozen=True)
class FrontendConfig:
    kind: str                  # "audio" | "vision"
    n_prefix: int = 0          # number of prefix embedding tokens (vision)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str             # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 => d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 4096         # sliding window for "local" layers
    mlp_kind: str = "swiglu"   # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    logit_softcap: float = 0.0
    sub_quadratic: bool = False  # eligible for the long_500k decode shape
    source: str = ""           # citation (paper / model card)
    dtype: str = "float32"     # compute/param dtype ("bfloat16" for dry-runs)

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_rnn(self) -> int:
        if self.ssm is None:
            return self.d_model
        return self.ssm.d_rnn or self.d_model

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_units(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def rem_kinds(self) -> Tuple[str, ...]:
        return self.layer_pattern[: self.n_layers % self.pattern_len]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, in order."""
        full = self.layer_pattern * self.n_units + self.rem_kinds
        assert len(full) == self.n_layers
        return full

    def with_dtype(self, dtype: str) -> "ModelConfig":
        return replace(self, dtype=dtype)

    def validate(self) -> None:
        for k in self.layer_pattern:
            assert k in LAYER_KINDS, k
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.mla
        if self.arch_type == "moe":
            assert self.moe is not None
        if self.arch_type in ("ssm", "hybrid"):
            assert any(k in ("rglru", "mlstm", "slstm") for k in self.layer_pattern)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of ``models.transformer.init_params`` (used for
    MODEL_FLOPS = 6*N*D), from its shapes on the ``meta`` device."""
    from repro_torch.models.transformer import init_params  # lazy: a cycle
    from repro_torch import tree as tu

    shapes = init_params(None, cfg, device="meta")
    return int(sum(t.numel() for t in tu.leaves(shapes)))


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: shared + top_k routed experts)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    inactive = (m.n_experts - m.top_k) * per_expert * _n_moe_layers(cfg)
    return total - inactive


def _n_moe_layers(cfg: ModelConfig) -> int:
    # MoE replaces the MLP in every attention-bearing layer.
    return sum(1 for k in cfg.layer_kinds() if k in ATTN_KINDS)


def reduced(cfg: ModelConfig, *, d_model: int = 256, n_units: int = 1,
            seed_vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (<=512 d_model, <=4 experts,
    n_layers = one pattern unit (plus remainder-free))."""
    plen = cfg.pattern_len
    n_layers = max(2, plen) * n_units if plen >= 2 else 2 * n_units
    # keep layer kinds from the same family
    scale = d_model / cfg.d_model
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = max(8, d_model // n_heads)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=max(8, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab_size=seed_vocab,
        window=min(cfg.window, 64),
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe,
            n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=max(8, int(cfg.moe.d_ff_expert * scale)),
            n_shared=min(1, cfg.moe.n_shared),
            d_ff_shared=max(8, int(cfg.moe.d_ff_shared * scale)) if cfg.moe.n_shared else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        kw["head_dim"] = 16
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_rnn=d_model if cfg.ssm.d_rnn else 0,
                            n_heads=min(2, cfg.ssm.n_heads))
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_ctx=16, d_model=d_model)
    if cfg.frontend is not None:
        kw["frontend"] = replace(cfg.frontend,
                                 n_prefix=min(8, cfg.frontend.n_prefix) or 0)
    return replace(cfg, **kw)
