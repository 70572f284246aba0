"""Backoff n-gram language model (analysis baseline): a copy of
``multimodal_baby_tpu/analysis/ngram.py``, kept so that the port imports
nothing of the JAX package.

Behavioral parity with the reference NGramModel (ngram.py:20-79): per-order
context->next-token counts, stupid-backoff-style scoring with backoff mass
``alpha`` (default 0.1) per skipped order, add-1 smoothed unigram floor, and
the same ``update`` / ``calculate_ce_loss`` API as the neural LM so the
analysis toolchain can swap them. numpy-based (host-side; counting is not
device work).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from math import log
import numpy as np


class NGramModel:
    def __init__(self, N: int, vocab_size: int):
        assert N >= 1, "N-gram model requires N >= 1"
        self._N = N
        self._count = [defaultdict(lambda: [0, Counter()])
                       for _ in range(N)]
        self._vocab_size = vocab_size

    @property
    def N(self) -> int:
        return self._N

    def update(self, y, y_len) -> None:
        """Accumulate counts from padded batches (sequences start with SOS).
        y: [B, L] int array; y_len: [B]."""
        y = np.asarray(y)
        y_len = np.asarray(y_len)
        for seq, seq_len in zip(y, y_len):
            seq = tuple(int(t) for t in seq[:int(seq_len)])
            for n in range(self._N):
                count = self._count[n]
                for i in range(max(1, n), len(seq)):
                    data = count[seq[i - n:i]]
                    data[0] += 1
                    data[1][seq[i]] += 1

    def calculate_ce_loss(self, y, y_len, alpha: float = 0.1,
                          tokenwise: bool = True):
        """Per-token NLL [B, L-1] (zeros at padding), or the token-mean."""
        y = np.asarray(y)
        y_len = np.asarray(y_len)
        loss = np.zeros((y.shape[0], y.shape[1] - 1), np.float32)
        n_tokens = 0
        log_alpha = log(alpha)
        log_1ma = log(1 - alpha)

        for bi, (seq, seq_len) in enumerate(zip(y, y_len)):
            seq = tuple(int(t) for t in seq[:int(seq_len)])
            for i in range(1, len(seq)):
                token_loss = 0.0
                for n in range(min(self._N - 1, i), -1, -1):
                    count = self._count[n]
                    ctx = seq[i - n:i]
                    if ctx in count:
                        total, next_counts = count[ctx]
                        if n == 0:
                            token_loss += (
                                log(next_counts.get(seq[i], 0) + 1)
                                - log(total + self._vocab_size))
                            break
                        if seq[i] in next_counts:
                            token_loss += (log(next_counts[seq[i]])
                                           - log(total) + log_1ma)
                            break
                    token_loss += log_alpha
                else:
                    raise RuntimeError("even the unigram is not applicable")
                loss[bi, i - 1] = -token_loss
                n_tokens += 1

        if not tokenwise:
            return loss.sum() / n_tokens
        return loss
