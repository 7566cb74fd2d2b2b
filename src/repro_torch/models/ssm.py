"""Recurrent blocks (the JAX package's ``models/ssm.py``): RG-LRU
(Griffin / RecurrentGemma) and xLSTM (mLSTM, sLSTM).

All three expose a full-sequence path (train / prefill) and an O(1)-state
decode path. The RG-LRU is a diagonal linear recurrence: the JAX package
runs it through ``jax.lax.associative_scan``, the port through a
log-depth doubling scan (``linear_scan``: ⌈log₂ S⌉ out-of-place steps
over the time axis, so ``torch.func.vmap`` and ``grad`` pass through it;
it adds in another order than the reference, so the two agree to
rounding, not bit for bit). mLSTM and sLSTM are sequential, as the
reference's ``lax.scan`` is: a Python loop over time. The reference has
no Pallas kernel here, so neither has the port.

Every state leaf is a new tensor: ``*_seq`` and ``*_decode`` write
nothing in place (``models/transformer.py`` copies a decode step's state
into the serving cache).

Under a ``ShardCtx`` with a model axis whose extent divides d_rnn (the
RG-LRU) or the head count (mLSTM, sLSTM) a rank runs its channels or
heads (``sharding.rules.tp_slice``): the input projection and the
convolution whole on every rank where the gates contract over every
channel (the RG-LRU's ``win``, the mLSTM's ``wup``), the rank's
gates, cells and state, the output projection row-parallel with one
``all_reduce``. A replicated tensor that the rank's own work starts
from goes through ``tp_local``, so its gradient is the ranks' sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (causal_conv1d, dense_init, dot, gelu,
                                      tp_row_matmul, zeros)
from repro_torch.sharding.collectives import (tp_active, tp_enter,
                                              tp_held, tp_local)
from repro_torch.sharding.ctx import CPU_CTX, ShardCtx
from repro_torch.sharding.rules import tp_width

RG_LRU_C = 8.0
M_INIT = -1e30          # the max-stabilisers' start: exp(. + M_INIT) is 0


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) everywhere (``F.softplus``
    turns linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = 0), as a doubling
    scan: after the step of span d, (a_t, b_t) composes the d positions
    up to t. a, b: (B, S, ...)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


# ------------------------------------------------------------------ RG-LRU
def rglru_init(generator, cfg, *, device=None, dtype=torch.float32):
    D, R = cfg.d_model, cfg.d_rnn
    cw = cfg.ssm.conv_width
    kw = dict(device=device, dtype=dtype)
    return {
        "win": dense_init((D, R), generator, **kw),
        "wgate": dense_init((D, R), generator, **kw),
        "conv": dense_init((cw, R), generator, fan_in=cw, **kw),
        "wa": dense_init((R, R), generator, **kw),
        "ba": zeros((R,), **kw),
        "wx": dense_init((R, R), generator, **kw),
        "bx": zeros((R,), **kw),
        # a = exp(-c * softplus(lam) * r); init for slow decay
        "lam": torch.full((R,), -4.0, **kw),
        "wout": dense_init((R, D), generator, **kw),
    }



def _rglru_split(p, ctx) -> bool:
    """Whether the RG-LRU's channels are split over ``ctx``'s model axis,
    as ``wout``'s rows (the rank's d_rnn / m) against ``win``'s columns
    (d_rnn: ``win`` and the convolution are whole on every rank) show."""
    return tp_active(ctx) and tp_held(ctx, p["win"].shape[-1],
                                      p["wout"].shape[-2])


def _rglru_gates(p, uc, ctx, split):
    """The gates of the rank's channels: they contract over every channel
    of ``uc`` (whole on every rank), ``b`` reads the rank's own."""
    uc = tp_local(uc, ctx, split)
    R = p["lam"].shape[-1]
    own = uc.narrow(-1, ctx.model_rank * R, R) if split else uc
    r = torch.sigmoid(dot(uc, p["wa"]) + p["ba"])
    i = torch.sigmoid(dot(uc, p["wx"]) + p["bx"])
    log_a = -RG_LRU_C * _softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    b = scale * (i.float() * own.float())
    return a, b


def rglru_seq(p, x, state=None, *, return_state=False,
              ctx: ShardCtx = CPU_CTX):
    """x: (B,S,D) -> (y, new_state). h_t = a_t * h_{t-1} + b_t. Under a
    model axis that splits d_rnn the rank runs its channels: ``u`` and
    its convolution whole, the gates, the scan and ``wgate`` the rank's,
    ``wout`` row-parallel; under sequence parallelism ``x`` and ``y``
    are the rank's rows (the scan runs over the gathered sequence)."""
    split = _rglru_split(p, ctx)
    x = tp_enter(x, ctx, False)
    g = dot(tp_local(x, ctx, split), p["wgate"])
    u = dot(x, p["win"])
    uc, conv_state = causal_conv1d(u, p["conv"],
                                   None if state is None else state["conv"])
    a, b = _rglru_gates(p, uc, ctx, split)                    # f32 (B,S,R)
    if state is not None:
        b0 = b[:, :1] + a[:, :1] * state["h"].float()[:, None]
        b = torch.cat([b0, b[:, 1:]], dim=1)
    h = linear_scan(a, b).to(x.dtype)
    y = tp_row_matmul(h * gelu(g), p["wout"], ctx, split)
    new_state = None
    if return_state:
        new_state = {"h": h[:, -1].clone(), "conv": conv_state.clone()}
    return y, new_state


def rglru_decode(p, x, state, ctx: ShardCtx = CPU_CTX):
    """x: (B,1,D); state {'h': (B,R), 'conv': (B,cw-1,R)} (under a split
    model axis ``h`` the rank's channels, ``conv`` whole)."""
    split = _rglru_split(p, ctx)
    g = x @ p["wgate"]
    u = x @ p["win"]
    uc, conv_state = causal_conv1d(u, p["conv"], state["conv"])
    a, b = _rglru_gates(p, uc, ctx, split)                    # (B,1,R)
    h = (a[:, 0] * state["h"].float() + b[:, 0]).to(x.dtype)
    y = tp_row_matmul(h[:, None] * gelu(g), p["wout"], ctx, split)
    return y, {"h": h, "conv": conv_state}


def init_rglru_state(cfg, B, dtype, device=None, model_size: int = 1):
    R, cw = cfg.d_rnn, cfg.ssm.conv_width
    return {"h": torch.zeros((B, tp_width(R, model_size)), dtype=dtype,
                             device=device),
            "conv": torch.zeros((B, cw - 1, R), dtype=dtype, device=device)}


# ------------------------------------------------------------------ mLSTM
def mlstm_init(generator, cfg, *, device=None, dtype=torch.float32):
    D = cfg.d_model
    Dm = 2 * D
    H = cfg.ssm.n_heads
    cw = cfg.ssm.conv_width
    kw = dict(device=device, dtype=dtype)
    return {
        "wup": dense_init((D, Dm), generator, **kw),
        "wz": dense_init((D, Dm), generator, **kw),
        "conv": dense_init((cw, Dm), generator, fan_in=cw, **kw),
        "wq": dense_init((Dm, Dm), generator, **kw),
        "wk": dense_init((Dm, Dm), generator, **kw),
        "wv": dense_init((Dm, Dm), generator, **kw),
        "wi": dense_init((Dm, H), generator, **kw),
        "bi": zeros((H,), **kw),
        "wf": dense_init((Dm, H), generator, **kw),
        "bf": torch.linspace(3.0, 6.0, H).to(**kw),   # long-memory init
        "gn": zeros((Dm,), **kw),
        "wdown": dense_init((Dm, D), generator, **kw),
    }


def _heads_split(cfg, held: int, ctx) -> bool:
    """Whether an xLSTM block's heads are split over ``ctx``'s model
    axis: its leaves hold ``held`` of ``cfg.ssm.n_heads`` heads."""
    return tp_active(ctx) and tp_held(ctx, cfg.ssm.n_heads, held)


def _mlstm_qkvif(p, cfg, x, conv_state, ctx, split):
    """The rank's heads' q, k, v, gates and z. ``wup`` and the
    convolution are whole on every rank (q / k / i / f contract over
    every channel of ``xc``, v over ``xu``), the heads' leaves the
    rank's."""
    B, S, _ = x.shape
    H = p["wi"].shape[-1]
    dh = p["wq"].shape[-1] // H
    xu = dot(x, p["wup"])
    z = dot(tp_local(x, ctx, split), p["wz"])
    xc, conv_state = causal_conv1d(xu, p["conv"], conv_state)
    xc = tp_local(F.silu(xc), ctx, split)
    xv = tp_local(xu, ctx, split)
    q = dot(xc, p["wq"]).reshape(B, S, H, dh) * (dh ** -0.5)
    k = dot(xc, p["wk"]).reshape(B, S, H, dh) * (dh ** -0.5)
    v = dot(xv, p["wv"]).reshape(B, S, H, dh)
    i = (dot(xc, p["wi"]) + p["bi"]).float()                  # (B,S,H) log-i
    f = (dot(xc, p["wf"]) + p["bf"]).float()
    logf = F.logsigmoid(f)
    return q, k, v, i, logf, z, conv_state


def _mlstm_step(state, qkvif):
    """Stabilized mLSTM cell. state: C (B,H,dh,dh), n (B,H,dh), m (B,H)."""
    C, n, m = state
    q, k, v, i, logf = qkvif                                  # (B,H,dh)x3,(B,H)x2
    m_new = torch.maximum(logf + m, i)
    i_p = torch.exp(i - m_new)[..., None]
    f_p = torch.exp(logf + m - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = f_p[..., None] * C + i_p[..., None] * (vf[..., :, None]
                                               * kf[..., None, :])
    n = f_p * n + i_p * kf
    qf = q.float()
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, qf).abs(), min=1.0)
    h = num / den[..., None]
    return (C, n, m_new), h


def _gn(h, scale, eps=1e-6):
    """Per-head group norm over the head dim (the population variance, as
    ``jnp.var``). h: (..., H, dh)."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = h32.var(-1, keepdim=True, correction=0)
    out = (h32 - mu) * torch.rsqrt(var + eps)
    flat = out.reshape(out.shape[:-2] + (-1,))
    return flat * (1.0 + scale.float())


def mlstm_seq(p, cfg, x, state=None, *, return_state=False,
              ctx: ShardCtx = CPU_CTX):
    """x: (B,S,D) -> (y, new_state). Under a model axis that splits the
    heads the rank runs its heads (``_mlstm_qkvif``), ``wdown``
    row-parallel; under sequence parallelism ``x`` and ``y`` are the
    rank's rows (the cells run over the gathered sequence)."""
    H = p["wi"].shape[-1]
    split = _heads_split(cfg, H, ctx)
    x = tp_enter(x, ctx, False)
    B, S, D = x.shape
    dh = p["wq"].shape[-1] // H
    conv_state = None if state is None else state["conv"]
    q, k, v, i, logf, z, conv_state = _mlstm_qkvif(p, cfg, x, conv_state,
                                                   ctx, split)
    if state is None:
        kw = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((B, H, dh, dh), **kw),
                 torch.zeros((B, H, dh), **kw),
                 torch.full((B, H), M_INIT, **kw))
    else:
        carry = (state["C"], state["n"], state["m"])
    hs = []
    for t in range(S):
        carry, h = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t], i[:, t],
                                       logf[:, t]))
        hs.append(h)
    h = torch.stack(hs, dim=1)                                # (B,S,H,dh)
    out = _gn(h, p["gn"]).to(x.dtype)
    y = tp_row_matmul(out * F.silu(z), p["wdown"], ctx, split)
    new_state = None
    if return_state:
        C, n, m = carry
        new_state = {"C": C, "n": n, "m": m, "conv": conv_state.clone()}
    return y, new_state


def mlstm_decode(p, cfg, x, state, ctx: ShardCtx = CPU_CTX):
    split = _heads_split(cfg, p["wi"].shape[-1], ctx)
    q, k, v, i, logf, z, conv_state = _mlstm_qkvif(p, cfg, x, state["conv"],
                                                   ctx, split)
    (C, n, m), h = _mlstm_step((state["C"], state["n"], state["m"]),
                               (q[:, 0], k[:, 0], v[:, 0], i[:, 0],
                                logf[:, 0]))
    out = _gn(h, p["gn"]).to(x.dtype)[:, None]
    y = tp_row_matmul(out * F.silu(z), p["wdown"], ctx, split)
    return y, {"C": C, "n": n, "m": m, "conv": conv_state}


def init_mlstm_state(cfg, B, dtype, device=None, model_size: int = 1):
    H = cfg.ssm.n_heads
    Dm = 2 * cfg.d_model
    dh = Dm // H
    Hl = tp_width(H, model_size)
    cw = cfg.ssm.conv_width
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, Hl, dh, dh), **kw),
            "n": torch.zeros((B, Hl, dh), **kw),
            "m": torch.full((B, Hl), M_INIT, **kw),
            "conv": torch.zeros((B, cw - 1, Dm), dtype=dtype, device=device)}


# ------------------------------------------------------------------ sLSTM
def slstm_init(generator, cfg, *, device=None, dtype=torch.float32):
    D = cfg.d_model
    H = cfg.ssm.n_heads
    dh = D // H
    kw = dict(device=device, dtype=dtype)
    p = {}
    for n in ("z", "i", "f", "o"):
        p[f"w{n}"] = dense_init((D, D), generator, **kw)
        p[f"b{n}"] = zeros((D,), **kw)
    for n in ("z", "i", "f", "o"):
        p[f"r{n}"] = dense_init((H, dh, dh), generator, fan_in=dh, **kw)
    p["bf_init"] = torch.linspace(3.0, 6.0, D).to(**kw)  # long-memory bias
    p["gn"] = zeros((D,), **kw)
    p["wout"] = dense_init((D, D), generator, **kw)
    return p


def _slstm_recur(p, h_prev, H, dh):
    hp = h_prev.reshape(h_prev.shape[0], H, dh)
    return {n: torch.einsum("bhd,hde->bhe", hp, p[f"r{n}"]).reshape(
        h_prev.shape) for n in ("z", "i", "f", "o")}


def _slstm_step(p, state, xg, H, dh):
    """state: (c, n, m, h) each (B,D) f32 (h in the model dtype)."""
    c, nrm, m, h = state
    xz, xi, xf, xo = xg
    r = _slstm_recur(p, h, H, dh)
    z = torch.tanh((xz + r["z"]).float())
    o = torch.sigmoid((xo + r["o"]).float())
    i_log = (xi + r["i"]).float()
    f_log = (xf + r["f"] + p["bf_init"]).float()
    m_new = torch.maximum(f_log + m, i_log)
    i_p = torch.exp(i_log - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c = f_p * c + i_p * z
    nrm = f_p * nrm + i_p
    h_new = (o * c / torch.clamp(nrm, min=1.0)).to(h.dtype)
    return (c, nrm, m_new, h_new)


def slstm_seq(p, cfg, x, state=None, *, return_state=False,
              ctx: ShardCtx = CPU_CTX):
    """x: (B,S,D) -> (y, new_state). Under a model axis that splits the
    heads the rank runs its heads' channels (the recurrence is block
    diagonal by head), ``wout``'s rows of them row-parallel; under
    sequence parallelism ``x`` and ``y`` are the rank's rows."""
    H = p["rz"].shape[-3]
    split = _heads_split(cfg, H, ctx)
    x = tp_enter(x, ctx, split)
    B, S, _ = x.shape
    D = p["wz"].shape[-1]
    dh = D // H
    xg = [dot(x, p[f"w{n}"]) + p[f"b{n}"] for n in ("z", "i", "f", "o")]
    if state is None:
        kw = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((B, D), **kw), torch.zeros((B, D), **kw),
                 torch.full((B, D), M_INIT, **kw),
                 torch.zeros((B, D), dtype=x.dtype, device=x.device))
    else:
        carry = (state["c"], state["n"], state["m"], state["h"])
    hs = []
    for t in range(S):
        carry = _slstm_step(p, carry, tuple(g[:, t] for g in xg), H, dh)
        hs.append(carry[3])
    h = torch.stack(hs, dim=1)                                # (B,S,D)
    out = _gn(h.reshape(B, S, H, dh), p["gn"]).to(x.dtype)
    y = tp_row_matmul(out, p["wout"], ctx, split)
    new_state = None
    if return_state:
        c, nrm, m, hl = carry
        new_state = {"c": c, "n": nrm, "m": m, "h": hl}
    return y, new_state


def slstm_decode(p, cfg, x, state, ctx: ShardCtx = CPU_CTX):
    B = x.shape[0]
    H = p["rz"].shape[-3]
    split = _heads_split(cfg, H, ctx)
    dh = p["wz"].shape[-1] // H
    xg = tuple(x[:, 0] @ p[f"w{n}"] + p[f"b{n}"] for n in ("z", "i", "f", "o"))
    c, nrm, m, h = _slstm_step(
        p, (state["c"], state["n"], state["m"], state["h"]), xg, H, dh)
    out = _gn(h.reshape(B, H, dh), p["gn"]).to(x.dtype)
    y = tp_row_matmul(out, p["wout"], ctx, split)[:, None]
    return y, {"c": c, "n": nrm, "m": m, "h": h}


def init_slstm_state(cfg, B, dtype, device=None, model_size: int = 1):
    D = tp_width(cfg.ssm.n_heads, model_size) * (cfg.d_model
                                                  // cfg.ssm.n_heads)
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, D), **kw),
            "n": torch.zeros((B, D), **kw),
            "m": torch.full((B, D), M_INIT, **kw),
            "h": torch.zeros((B, D), dtype=dtype, device=device)}
