"""Batch pipeline for LM training (the JAX package's
``data/pipeline.py``): deterministic, host-side numpy batches over the
port's ``lm_sequences``, byte-identical to the reference's for the same
seed. ``host_slice`` cuts a global batch into one host's share."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import lm_sequences


class LMPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int, *,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        seqs = lm_sequences(self.vocab_size, self.global_batch, self.seq_len,
                            seed=self.seed * 100_003 + self._step)
        self._step += 1
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def host_slice(self, batch: Dict[str, np.ndarray], host_id: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
        b = self.global_batch // n_hosts
        return {k: v[host_id * b:(host_id + 1) * b] for k, v in batch.items()}
