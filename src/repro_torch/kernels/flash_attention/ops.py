"""Dispatch and autograd binding for flash attention — a
``blockwise_attention`` drop-in with a hand-written backward.

The device rule is the port's: on CUDA tensors the CUDA kernels
(``flash.py``) or an error, on CPU tensors the plain versions
(``ref.py``); ``use_kernel=False`` forces the plain version,
``use_kernel=True`` on CPU tensors raises.

The differentiable core works on the kernel layout q ``(B, KV, G, S,
hd)`` with block-padded sequences; padding, transposes and the final
slice live OUTSIDE it, so autograd differentiates them natively (as the
JAX package keeps them outside its ``custom_vjp``). The core is two
``torch.autograd.Function``s — the forward, whose backward applies the
second, the dq/dk/dv launch — both in the ``setup_context`` form with a
``vmap`` rule, so ``torch.func.vmap(grad(loss))`` works through them:
the rule folds the vmapped axis into the kernel's batch axis B
(``(n, B, ...) -> (n·B, ...)``), launches ONCE for all n, and unfolds.
Positions stay shared across the vmapped axis.

Block sizes are capped at ``BLOCK_CAP`` (=128) as in the JAX package;
they set the padding (and the plain version's kv blocks), while the
CUDA kernels tile on their own (``kernels/csrc/flash_attention.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import kernel_for
from repro_torch.kernels.flash_attention import flash, ref

BLOCK_CAP = 128


def _fold(x, d, n):
    """Move the vmapped axis ``d`` (None = unbatched: broadcast) to the
    front and merge it into the next axis."""
    x = x.expand(n, *x.shape) if d is None else x.movedim(d, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x, n):
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _shared_positions(in_dims) -> None:
    if in_dims[3] is not None or in_dims[4] is not None:
        raise ValueError("flash attention under vmap: q_pos/kv_pos must be "
                         "shared across the vmapped axis")


class _FlashBwd(torch.autograd.Function):
    """The backward launch: (dq, dk, dv) from the forward's residuals."""

    @staticmethod
    def forward(q, k, v, q_pos, kv_pos, out, lse, dout, causal, window,
                block_kv, use_kernel):
        if not use_kernel:
            return ref.flash_bwd_ref(q, k, v, q_pos, kv_pos, out, lse, dout,
                                     causal=causal, window=window,
                                     block_kv=block_kv)
        do = dout.float().contiguous()
        delta = (do * out).sum(dim=-1)
        return flash.flash_bwd(q, k, v, q_pos, kv_pos, lse, delta, do,
                               causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention is differentiable once")

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, kv_pos, out, lse, dout, causal,
             window, block_kv, use_kernel):
        _shared_positions(in_dims)
        n = info.batch_size
        f = [_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3])]
        r = [_fold(x, d, n) for x, d in zip((out, lse, dout), in_dims[5:8])]
        dq, dk, dv = _FlashBwd.apply(*f, q_pos, kv_pos, *r, causal, window,
                                     block_kv, use_kernel)
        return (_unfold(dq, n), _unfold(dk, n), _unfold(dv, n)), (0, 0, 0)


class _Flash(torch.autograd.Function):
    """The forward launch: (out, lse); lse is a residual, not
    differentiable."""

    @staticmethod
    def forward(q, k, v, q_pos, kv_pos, causal, window, block_kv,
                use_kernel):
        if not use_kernel:
            return ref.flash_fwd_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, block_kv=block_kv)
        return flash.flash_fwd(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, kv_pos, causal, window, block_kv, use_kernel = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.args = (causal, window, block_kv, use_kernel)

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBwd.apply(q, k, v, q_pos, kv_pos, out, lse, dout,
                                     *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, kv_pos, causal, window,
             block_kv, use_kernel):
        _shared_positions(in_dims)
        n = info.batch_size
        f = [_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3])]
        out, lse = _Flash.apply(*f, q_pos, kv_pos, causal, window, block_kv,
                                use_kernel)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


def pad_to(x, size: int, dim: int, value=0):
    """``x`` padded with ``value`` at the end of ``dim`` to ``size``."""
    pad = size - x.shape[dim]
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, pad]
    return F.pad(x, widths, value=value)


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: int = 0, block_q: int = 512, block_kv: int = 512,
                    use_kernel: Optional[bool] = None):
    """Flash attention with a hand-written backward. Same contract as
    ``models.attention.blockwise_attention``: q (B,Sq,KV,G,hd);
    k, v (B,Sk,KV,hd); q_pos (Sq,) / kv_pos (Sk,) absolute positions
    (-1 = masked key). Returns (B,Sq,KV*G,hd) in q.dtype."""
    use_kernel = kernel_for(use_kernel, q.device)
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    bq = max(1, min(block_q, BLOCK_CAP, Sq))
    bk = max(1, min(block_kv, BLOCK_CAP, Sk))
    nq, nk = -(-Sq // bq), -(-Sk // bk)

    dt = torch.float32 if use_kernel else q.dtype
    qt = pad_to(q.to(dt), nq * bq, 1).permute(0, 2, 3, 1, 4).contiguous()
    kp = pad_to(k.to(dt), nk * bk, 1).contiguous()
    vp = pad_to(v.to(dt), nk * bk, 1).contiguous()
    qpos_p = pad_to(q_pos.to(torch.int32), nq * bq, 0, value=-1)
    kpos_p = pad_to(kv_pos.to(torch.int32), nk * bk, 0, value=-1)

    out, _ = _Flash.apply(qt, kp, vp, qpos_p.contiguous(),
                          kpos_p.contiguous(), bool(causal), int(window), bk,
                          use_kernel)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, nq * bq, KV * G, hd)
    return out[:, :Sq].to(q.dtype)
