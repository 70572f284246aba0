"""A copy of ``multimodal_baby_tpu/data/vocab.py`` (a test holds the two
equal), kept so that the port imports nothing of the JAX package.

Vocabulary: the word <-> id mapping shared by training, eval and the
public ``tokenize`` API.

Data contract matches the reference vocab.json (dict word -> id with the four
special tokens at ids 0-3; built from training utterances at frequency >= 3;
reference: multimodal/multimodal_saycam_data_module.py:1219-1263).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN, PAD_TOKEN, SOS_TOKEN, SPECIAL_TOKENS, UNK_TOKEN,
    UNK_TOKEN_ID)


class Vocab:
    def __init__(self, word2idx: Dict[str, int]):
        self.word2idx = word2idx
        self.idx2word = {idx: word for word, idx in word2idx.items()}

    def __len__(self) -> int:
        return len(self.word2idx)

    def __contains__(self, word: str) -> bool:
        return word in self.word2idx

    def __getitem__(self, word: str) -> int:
        return self.word2idx[word]

    def get(self, word: str, default: int = UNK_TOKEN_ID) -> int:
        return self.word2idx.get(word, default)

    def to_ids(self, words: Iterable[str]) -> List[int]:
        return [self.get(w) for w in words]

    def to_words(self, ids: Iterable[int]) -> List[str]:
        return [self.idx2word[int(i)] for i in ids]

    # ---- persistence (reference-compatible vocab.json) ----

    @staticmethod
    def load(path) -> "Vocab":
        with open(path) as f:
            return Vocab(json.load(f))

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.word2idx, f)

    @staticmethod
    def build(utterances: Iterable[str], min_freq: int = 3) -> "Vocab":
        """Build from whitespace-tokenized utterances, frequency >= min_freq,
        ordered by (-frequency, token) after the 4 special tokens — the
        reference's exact id assignment
        (multimodal_saycam_data_module.py:1219-1263)."""
        counter: Counter = Counter()
        for utt in utterances:
            counter.update(utt.split())
        ordered = sorted(counter.most_common(),
                         key=lambda item: (-item[1], item[0]))
        word2idx = {tok: i for i, tok in enumerate(SPECIAL_TOKENS)}
        for word, freq in ordered:
            if freq >= min_freq and word not in word2idx:
                word2idx[word] = len(word2idx)
        return Vocab(word2idx)
