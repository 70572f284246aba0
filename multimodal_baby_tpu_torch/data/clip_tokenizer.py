"""CLIP's byte-level BPE tokenizer, built from a model directory's
``vocab.json`` and ``merges.txt``: what the JAX package's CLIP baseline
gets from ``transformers.CLIPTokenizerFast`` (its ``tokenizers`` pipeline),
written with ``re`` and ``unicodedata`` only.

    tok = CLIPTokenizer.from_pretrained("openai/clip-vit-large-patch14")
    batch = tok(["a photo of a ball", "a photo of a cat"])
    batch["input_ids"], batch["attention_mask"]   # [N, L] int64 tensors

Each text is NFC-normalized, its whitespace runs made one space, and
lowercased character by character; then split as CLIP's pattern
``'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+`` splits it;
each piece's UTF-8 bytes go through GPT-2's byte-to-unicode table, its
last symbol gets ``</w>``, and the merges apply by rank.
``<|startoftext|>`` and ``<|endoftext|>`` wrap the ids, and a batch is
padded to its longest text with the pad token (``<|endoftext|>`` unless
the directory's ``special_tokens_map.json`` or ``tokenizer_config.json``
names another), as ``tokenizer(texts, padding=True)`` does; the
attention mask marks the real tokens.
"""

from __future__ import annotations

import functools
import itertools
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import torch

from multimodal_baby_tpu_torch.api.hf_dir import resolve_model_dir

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
# CLIP's pattern in ``re``: letters are word characters that are neither
# decimal digits nor "_"; the other numerals (No, Nl), which \w also holds,
# are split off each on its own afterwards (``_pieces``); "_" is
# punctuation, as \p{L} and \p{N} do not hold it
_PATTERN = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+")
_SPACES = re.compile(r"\s+")


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: every byte to a printable character (the printable
    Latin-1 bytes to themselves, the others to 256 and up)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_numeral(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _pieces(text: str) -> List[str]:
    """The normalized text split as CLIP's pattern splits it."""
    text = _SPACES.sub(" ", unicodedata.normalize("NFC", text))
    # character by character, as the tokenizers library lowercases: no
    # final sigma
    text = "".join(ch.lower() for ch in text)
    out = []
    for piece in _PATTERN.findall(text):
        if len(piece) > 1 and any(map(_is_numeral, piece)):
            # a run of letters holding No/Nl numerals: each numeral alone
            for numeral, run in itertools.groupby(piece, _is_numeral):
                out.extend(run if numeral else ["".join(run)])
        else:
            out.append(piece)
    return out


def _special(model_dir: Path, key: str, default: str) -> str:
    for fname in ("special_tokens_map.json", "tokenizer_config.json"):
        path = model_dir / fname
        if path.is_file():
            value = json.loads(path.read_text()).get(key)
            if isinstance(value, dict):
                value = value.get("content")
            if isinstance(value, str):
                return value
    return default


class CLIPTokenizer:
    """``vocab``: token -> id; ``merges``: the merge pairs in rank order."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]], bos: str = BOS,
                 eos: str = EOS, pad: str = EOS, unk: str = EOS):
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        for name, token in (("bos", bos), ("eos", eos), ("pad", pad),
                            ("unk", unk)):
            if token not in self.vocab:
                raise ValueError(f"CLIPTokenizer: the {name} token "
                                 f"{token!r} is not in the vocabulary")
        self.bos_id, self.eos_id = self.vocab[bos], self.vocab[eos]
        self.pad_id, self.unk_id = self.vocab[pad], self.vocab[unk]
        self._byte = bytes_to_unicode()
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_pretrained(cls, name: Union[str, Path]) -> "CLIPTokenizer":
        """From a local directory or the cache (``resolve_model_dir``)."""
        model_dir = resolve_model_dir(name)
        vocab = json.loads((model_dir / "vocab.json").read_text("utf-8"))
        merges = []
        for line in (model_dir / "merges.txt").read_text(
                "utf-8").splitlines():
            if line.startswith("#version") or not line.strip():
                continue
            a, b = line.split()
            merges.append((a, b))
        return cls(vocab, merges, **{
            key: _special(model_dir, f"{key}_token", default)
            for key, default in (("bos", BOS), ("eos", EOS), ("pad", EOS),
                                 ("unk", EOS))})

    def _bpe(self, piece: str) -> List[int]:
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        chars = [self._byte[b] for b in piece.encode("utf-8")]
        word = chars[:-1] + [chars[-1] + "</w>"]
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, len(
                self.ranks)))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = self._cache[piece] = [self.vocab.get(t, self.unk_id)
                                    for t in word]
        return ids

    def encode(self, text: str) -> List[int]:
        """``<|startoftext|>``, the text's BPE ids, ``<|endoftext|>``."""
        return ([self.bos_id]
                + [i for piece in _pieces(text) for i in self._bpe(piece)]
                + [self.eos_id])

    def __call__(self, texts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """``input_ids`` and ``attention_mask`` ``[len(texts), L]`` int64,
        L the longest text's length, the rest padded with the pad id."""
        rows = [self.encode(t) for t in texts]
        width = max(map(len, rows))
        ids = torch.full((len(rows), width), self.pad_id, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, row in enumerate(rows):
            ids[i, :len(row)] = torch.tensor(row)
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}
