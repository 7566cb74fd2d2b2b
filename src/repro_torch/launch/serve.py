"""Serving launcher: batched prefill + decode (the JAX package's
``launch/serve.py``), on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
      --n-layers 12 --batch 4 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --n-layers 8 --batch 2 --prompt-len 8192 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --n-layers 3 --batch 2 --prompt-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --batch 4 --prompt-len 416 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
      --batch 4 --prompt-len 3840 --gen 32

Random weights from ``--seed``, random prompts; greedy decoding, or
sampling at ``--temperature`` from an explicit ``torch.Generator`` (its
numbers are not ``jax.random``'s). A config with a front end gets random
normal ``aux`` embeddings from the same generator, as the reference
draws them: (B, n_prefix, D) patch embeddings ahead of the prompt for
the vision front end (the cache and the decode positions then count
them), (B, n_ctx, D) frames for the whisper encoder. Prefill builds the
decode cache (ring caches of ``window`` slots on local layers, the cross
kv on whisper's decoder layers); each decode step writes the new token
into it. On the card the attention runs through the port's
kernels (module docstring of ``models/attention.py``). ``--n-layers``
cuts the depth (the only way to fit a large config's f32 weights on one
card); the widths stay the published ones unless ``--reduced``.

``run(..., ctx=)`` serves under a ``ShardCtx`` with a model axis (every
rank of it calls ``run``): each rank draws the whole model from the seed
and keeps its part (``sharding.rules.tp_slice``), the logits and caches
are the rank's (its vocabulary columns, its kv heads), and the greedy
token is the argmax across the ranks, the lower id on a tie
(``sharding.collectives.vocab_argmax``); sampling reads the gathered
logits. Under data axes of d > 1 ranks (FSDP) every rank draws the same
prompts (and ``aux``) and serves its contiguous ``batch / d`` rows of
them (``sharding.rules.cache_rows``); its parameters are its data part,
gathered a unit at a time in every prefill and decode step, its logits
and cache are its rows, and the tokens returned are every rank's rows in
order. A batch d does not divide (or one smaller than d: the
reference's rule, ``sharding.rules.batch_splits``; long-context decode
at batch 1) is served whole on every data rank instead: each attention
cache holds the rank's block of slots, every decode step combines the
ranks' attention over the data axes (``sharding.collectives.
combine_seq``), and every data rank returns the same logits and tokens,
every row's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import DeviceLike, resolve_device, strict_f32
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.sharding.collectives import (dp_active, gather_padded,
                                              gather_vocab, vocab_argmax)
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.sharding.rules import batch_ctx, cache_rows, tp_slice


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, use_reduced: bool = True, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, seed: int = 0,
        temperature: float = 0.0, device: DeviceLike = None,
        n_layers: Optional[int] = None, n_experts: Optional[int] = None,
        ctx: Optional[ShardCtx] = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens. Returns the generated tokens ``(B, gen)`` and
    what produced them: ``prompts``, ``aux`` (None without a front end),
    ``params``, ``cfg``, the prefill's
    last logits, the last step's ``logits`` and ``cache``, and the times
    (``prefill_s``; ``decode_first_s``, the first, warm-up, step;
    ``decode_ms_per_token`` over the others). Under ``ctx``'s mesh
    (module docstring) ``params``, the logits and ``cache`` are the
    rank's part; ``rows`` says which of the batch's rows the rank
    served (all of them without data axes, and where they do not split
    the batch: every data rank then returns the same tokens)."""
    dev = resolve_device(device)
    strict_f32(dev)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts,
            top_k=min(cfg.moe.top_k, n_experts)))
    cfg.validate()
    npx = T.vision_prefix(cfg)
    cache_len = npx + prompt_len + gen
    ctx = batch_ctx(batch, ctx or ShardCtx())
    rows = cache_rows(batch, ctx)
    g = torch.Generator(device=dev).manual_seed(seed)
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    prefill = make_prefill_step(cfg, ctx=ctx, cache_len=cache_len)
    decode = make_decode_step(cfg, ctx=ctx, cache_len=cache_len)
    with torch.inference_mode():
        params = tp_slice(T.init_params(g, cfg, device=dev), ctx, cfg)
        lo = T.vocab_lo(params, cfg, ctx)

        def pick(logits):
            if temperature > 0:
                if lo is not None:
                    logits = gather_vocab(logits, ctx)
                probs = torch.softmax(logits / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=sampler)
            if lo is None:
                return logits.argmax(-1)[:, None]
            return vocab_argmax(logits, ctx, lo)[:, None]

        shape = T.aux_shape(cfg, batch)
        aux = (None if shape is None else
               torch.randn(shape, generator=g, device=dev,
                           dtype=T._param_dtype(cfg)))
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=g, device=dev, dtype=torch.int32)
        b = {"tokens": prompts[rows]}
        if aux is not None:
            b["aux"] = aux[rows]
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, b)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits
        toks = []
        tok = (logits.argmax(-1)[:, None] if lo is None else
               vocab_argmax(logits, ctx, lo)[:, None]).to(torch.int32)
        t_first = 0.0
        t1 = time.perf_counter()
        for i in range(gen):
            toks.append(tok)
            logits, cache = decode(params, tok, cache, npx + prompt_len + i)
            tok = pick(logits).to(torch.int32)
            if i == 0:
                _sync(dev)
                t_first = time.perf_counter() - t1
                t1 = time.perf_counter()
        _sync(dev)
        t_rest = time.perf_counter() - t1
        out = torch.cat(toks, dim=1)
        if dp_active(ctx) and not ctx.batch_whole:
            out = gather_padded(out, 0, ctx.data_rank, ctx.data_size,
                                ctx.data_sum)
    ms_tok = t_rest / (gen - 1) * 1e3 if gen > 1 else float("nan")
    print(f"arch={cfg.name} layers={cfg.n_layers} device={dev} "
          f"prefill({batch}x{prompt_len})={t_prefill * 1e3:.1f}ms "
          f"decode {gen} toks: first={t_first * 1e3:.1f}ms, then "
          f"{ms_tok:.2f} ms/tok")
    print("sample tokens:", out[0][:12].tolist())
    return {"tokens": out, "prompts": prompts, "aux": aux,
            "params": params, "cfg": cfg, "rows": rows,
            "prefill_logits": prefill_logits, "logits": logits,
            "cache": cache, "prefill_s": t_prefill,
            "decode_first_s": t_first, "decode_ms_per_token": ms_tok}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--n-experts", type=int, default=None,
                    help="cut a MoE config's routed experts to this many")
    args = ap.parse_args()
    run(args.arch, use_reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
        temperature=args.temperature, device=args.device,
        n_layers=args.n_layers, n_experts=args.n_experts)


if __name__ == "__main__":
    main()
