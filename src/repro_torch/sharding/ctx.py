"""The context threaded through model code — the JAX package's
``ShardCtx`` with only the fields the port's model path reads.

There is no mesh: the port runs on one card, so ``model_size`` is 1 and
the head layout is the identity (``models/attention.py``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShardCtx:
    attn_backend: str = "auto"          # "auto" | "flash" | "blockwise":
                                        # auto = the CUDA kernels on CUDA
                                        # tensors (flash, swa_prefill,
                                        # swa_decode: models/attention.py),
                                        # the plain versions elsewhere
    banded_local: bool = True           # banded blockwise attn, local layers
    causal_skip: bool = False           # skip fully-masked kv blocks (causal)
    block_q: int = 512
    block_kv: int = 512
    remat: bool = False                 # layer checkpointing (not ported)

    @property
    def model_size(self) -> int:
        return 1


CPU_CTX = ShardCtx()
