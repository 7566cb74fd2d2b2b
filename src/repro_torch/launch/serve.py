"""Serving launcher: batched prefill + decode (the JAX package's
``launch/serve.py``), on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
      --n-layers 12 --batch 4 --prompt-len 4096 --gen 32

Random weights from ``--seed``, random prompts; greedy decoding, or
sampling at ``--temperature`` from an explicit ``torch.Generator`` (its
numbers are not ``jax.random``'s). Prefill builds the decode cache (ring
caches of ``window`` slots on local layers); each decode step writes the
new token into it. On the card the attention runs through the port's
kernels (module docstring of ``models/attention.py``). ``--n-layers``
cuts the depth (the only way to fit a large config's f32 weights on one
card); the widths stay the published ones unless ``--reduced``.
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
from repro_torch.sharding.ctx import ShardCtx


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, use_reduced: bool = True, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, seed: int = 0,
        temperature: float = 0.0, device: DeviceLike = None,
        n_layers: Optional[int] = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens. Returns the generated tokens ``(B, gen)`` and
    what produced them: ``prompts``, ``params``, ``cfg``, the prefill's
    last logits, the last step's ``logits`` and ``cache``, and the times
    (``prefill_s``; ``decode_first_s``, the first, warm-up, step;
    ``decode_ms_per_token`` over the others)."""
    dev = resolve_device(device)
    strict_f32(dev)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        cfg.validate()
    cache_len = prompt_len + gen
    ctx = ShardCtx()
    g = torch.Generator(device=dev).manual_seed(seed)
    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    prefill = make_prefill_step(cfg, ctx=ctx, cache_len=cache_len)
    decode = make_decode_step(cfg, ctx=ctx)
    with torch.inference_mode():
        params = T.init_params(g, cfg, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=g, device=dev, dtype=torch.int32)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts})
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits
        toks = []
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        t_first = 0.0
        t1 = time.perf_counter()
        for i in range(gen):
            toks.append(tok)
            logits, cache = decode(params, tok, cache, prompt_len + i)
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=sampler)
            else:
                tok = logits.argmax(-1)[:, None]
            tok = tok.to(torch.int32)
            if i == 0:
                _sync(dev)
                t_first = time.perf_counter() - t1
                t1 = time.perf_counter()
        _sync(dev)
        t_rest = time.perf_counter() - t1
        out = torch.cat(toks, dim=1)
    ms_tok = t_rest / (gen - 1) * 1e3 if gen > 1 else float("nan")
    print(f"arch={cfg.name} layers={cfg.n_layers} device={dev} "
          f"prefill({batch}x{prompt_len})={t_prefill * 1e3:.1f}ms "
          f"decode {gen} toks: first={t_first * 1e3:.1f}ms, then "
          f"{ms_tok:.2f} ms/tok")
    print("sample tokens:", out[0][:12].tolist())
    return {"tokens": out, "prompts": prompts, "params": params, "cfg": cfg,
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
    args = ap.parse_args()
    run(args.arch, use_reduced=args.reduced, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
        temperature=args.temperature, device=args.device,
        n_layers=args.n_layers)


if __name__ == "__main__":
    main()
