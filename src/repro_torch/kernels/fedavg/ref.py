"""Plain PyTorch versions of the fedavg aggregation kernels.

Each function computes what one hand-written kernel of
``kernels/fedavg/fedavg.py`` computes, with ordinary tensor ops. The
CPU path of ``ops`` runs them, the CPU tests hold them against the JAX
package's ``ref.py``, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import torch


def weighted_sum_ref(x, w):
    """x: (K, N); w: (K,) -> (N,) f32."""
    return torch.einsum("k,kn->n", w.float(), x.float())


def plane_agg_ref(x, w, *, masks=None, mult=None, fallback=None,
                  renorm: bool = True):
    """x [, masks, mult]: (K, N); w: (K,); [fallback: (N,)] -> (N,) f32.

    Coverage-weighted (optionally multiplicity-aware) average with the
    fallback substituted on coordinates no client covers — the plain
    version of ``fedavg.plane_agg_2d``."""
    if masks is None:
        assert mult is None and fallback is None
        return weighted_sum_ref(x, w)
    out = weighted_sum_masked_ref(x, w, masks, mult=mult, renorm=renorm)
    if fallback is not None:
        covered = masks.float().sum(0) > 0
        out = torch.where(covered, out, fallback.float())
    return out


def plane_accum_ref(num, den, cov, x, w, m=None, mu=None):
    """Streaming accumulate: num/den/cov ``(N,)`` (or ``(1, N)``) running
    buffers, x [, m, mu]: ``(K_chunk, N)``, w: ``(K_chunk,)`` -> the
    updated (num, den, cov): num += Σ w·m[/mu]·x, den += Σ w·m[/mu],
    cov += Σ m (m = 1 when absent). Returns new tensors."""
    keep = num.dim() == 2
    xf = x.float()
    wf = w.float()
    if m is None and mu is None:
        # unmasked Eq. 1 chunk: one product instead of (K_chunk, N)
        # temporaries — den/cov updates collapse to scalars
        s = wf @ xf
        return (num + (s[None] if keep else s), den + wf.sum(),
                cov + float(x.shape[0]))
    mf = m.float() if m is not None else torch.ones_like(xf)
    wm = wf[:, None] * mf
    if mu is not None:
        muf = mu.float()
        wm = wm / torch.where(muf > 0, muf, 1.0)
    return (num + (wm * xf).sum(0, keepdim=keep),
            den + wm.sum(0, keepdim=keep),
            cov + mf.sum(0, keepdim=keep))


def plane_finish_ref(num, den, cov, fallback=None, *, renorm: bool = True):
    """The divide pass closing a streamed accumulation: renorm divides num
    by den where den > 0; coordinates no client covered (cov == 0) take
    ``fallback`` — so accumulate-then-finish equals ``plane_agg_ref``."""
    out = num.float()
    if renorm:
        den = den.float()
        out = torch.where(den > 0, out / torch.where(den > 0, den, 1.0), 0.0)
    if fallback is not None:
        out = torch.where(cov > 0, out, fallback.float())
    return out


def weighted_sum_masked_ref(x, w, m, *, mult=None, renorm: bool = True):
    """x, m [, mult]: (K, N); w: (K,) -> (N,) f32 — coverage-weighted
    average; with ``mult`` the per-coordinate client weight is
    ``w_k m_k / mult_k``."""
    wm = w.float()[:, None] * m.float()
    if mult is not None:
        mu = mult.float()
        wm = wm / torch.where(mu > 0, mu, 1.0)
    num = (wm * x.float()).sum(0)
    if not renorm:
        return num
    den = wm.sum(0)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
