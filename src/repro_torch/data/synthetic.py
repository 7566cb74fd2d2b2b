"""Synthetic datasets (offline gate — repro band 2/5: MNIST/CIFAR are not
downloadable in this container; DESIGN.md §2).

Two generators:

  * ``image_classification`` — a frozen random convnet "teacher" labels
    latent-structured images. Difficulty is controlled by the number of
    classes and label noise, giving MNIST-like ("easy") and CIFAR-like
    ("hard") proxies for the Table-1 experiments. Collaboration helps
    because every client's data comes from the same teacher.
  * ``lm_sequences`` — Zipf-distributed token streams from a random
    order-1 Markov source (shared transition structure), for LM training
    of the transformer families.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class ImageTaskSpec:
    name: str
    n_classes: int
    image_size: int = 32
    channels: int = 3
    latent_dim: int = 24
    label_noise: float = 0.0
    seed: int = 0


EASY = ImageTaskSpec("synth-easy", n_classes=10, label_noise=0.0, seed=11)
MEDIUM = ImageTaskSpec("synth-medium", n_classes=10, label_noise=0.15, seed=12)
HARD = ImageTaskSpec("synth-hard", n_classes=20, label_noise=0.1,
                     latent_dim=48, seed=13)
HARDEST = ImageTaskSpec("synth-hardest", n_classes=50, label_noise=0.15,
                        latent_dim=64, seed=14)

TABLE1_TASKS = (EASY, MEDIUM, HARD, HARDEST)  # MNIST/F-MNIST/CIFAR-10/100 proxies


def _teacher_logits(rng: np.random.Generator, z: np.ndarray, n_classes: int):
    """Frozen 2-layer MLP teacher on the latent code."""
    d = z.shape[1]
    w1 = rng.standard_normal((d, 64)) / np.sqrt(d)
    w2 = rng.standard_normal((64, n_classes)) / np.sqrt(64)
    return np.maximum(z @ w1, 0.0) @ w2


def image_classification(spec: ImageTaskSpec, n: int, *, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Returns {'x': (n, S, S, C) float32, 'y': (n,) int32}."""
    rng_task = np.random.default_rng(spec.seed)          # frozen task params
    rng = np.random.default_rng((spec.seed + 1) * 77 + seed)
    z = rng.standard_normal((n, spec.latent_dim)).astype(np.float32)
    logits = _teacher_logits(rng_task, z, spec.n_classes)
    y = logits.argmax(-1).astype(np.int32)
    # render latents into images via a frozen linear decoder + nonlinearity
    dec = rng_task.standard_normal(
        (spec.latent_dim, spec.image_size * spec.image_size * spec.channels)
    ).astype(np.float32) / np.sqrt(spec.latent_dim)
    x = np.tanh(z @ dec).reshape(n, spec.image_size, spec.image_size,
                                 spec.channels)
    x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    if spec.label_noise > 0:
        flip = rng.random(n) < spec.label_noise
        y = np.where(flip, rng.integers(0, spec.n_classes, n), y).astype(np.int32)
    return {"x": x.astype(np.float32), "y": y}


def lm_sequences(vocab_size: int, n_seqs: int, seq_len: int, *,
                 seed: int = 0, order: int = 1) -> np.ndarray:
    """Zipf-weighted Markov token streams -> (n_seqs, seq_len+1) int32.

    The +1 column lets callers split into (inputs, next-token labels).
    """
    rng_task = np.random.default_rng(1234)
    rng = np.random.default_rng(seed)
    V = vocab_size
    branch = 32                                           # sparse transitions
    succ = rng_task.integers(0, V, size=(V, branch))
    zipf = 1.0 / (np.arange(1, branch + 1) ** 1.2)
    zipf = zipf / zipf.sum()
    out = np.empty((n_seqs, seq_len + 1), np.int32)
    state = rng.integers(0, V, size=n_seqs)
    for t in range(seq_len + 1):
        out[:, t] = state
        choice = rng.choice(branch, size=n_seqs, p=zipf)
        state = succ[state, choice]
    return out
