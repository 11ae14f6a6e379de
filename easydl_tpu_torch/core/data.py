"""Synthetic data for the port (counterpart of ``easydl_tpu/core/data.py``).

Batches are numpy arrays drawn from ``np.random.default_rng(seed)``, the
same draws as the JAX package's stream, so both packages train on
identical batches from the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticTokens:
    """LM token stream (GPT)."""

    def __init__(self, global_batch: int, seq_len: int, vocab: int = 32000, seed: int = 0):
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab = vocab
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            tokens = self._rng.integers(
                0, self.vocab, (self.global_batch, self.seq_len + 1), dtype=np.int32
            )
            yield {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
