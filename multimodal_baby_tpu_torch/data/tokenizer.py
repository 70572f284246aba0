"""A copy of ``multimodal_baby_tpu/data/tokenizer.py`` (a test holds the
two equal on a fixed sentence set and the packaged vocab), kept so that the
port imports nothing of the JAX package.

Tokenizer for the public ``tokenize`` API.

The reference tokenizes with spaCy ``en_core_web_sm``
(multimodal/multimodal_lit.py:161-190). We use spaCy when the model is
installed; otherwise a rule-based fallback implementing the slice of
spaCy's algorithm (prefix strip, suffix strip, exceptions, letter-infix
hyphen split) this corpus exercises.

The fallback's fidelity is MEASURED, not asserted: the packaged SAYCam
``vocab.json`` is itself spaCy tokenizer output (the reference ETL
space-joins spaCy tokens, multimodal_saycam_data_module.py:409-413, and
the vocab counts them, :1233-1259), so every vocab entry must round-trip
through the fallback unchanged. ``tests/test_tokenizer_fixture.py`` runs
that round-trip over all 2350 real corpus tokens plus a curated
utterance fixture, and documents the known divergence envelope (the
handful of vocab entries that are unsplit contraction forms from
non-spaCy transcript paths).

Output contract is identical: ids padded to 25 with <sos>/<eos>/<unk>/<pad>,
plus true lengths.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple, Union

import numpy as np

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, MAX_LEN_UTTERANCE, PAD_TOKEN_ID, SOS_TOKEN_ID)
from multimodal_baby_tpu_torch.data.vocab import Vocab

_SPACY_NLP = None
_SPACY_TRIED = False

_APOS = "'’"  # ASCII + curly apostrophe (both occur in transcripts)

# spaCy en tokenizer exceptions exercised by this corpus — each one is
# evidenced by the packaged vocab ("c'm"/"on", "gon"/"na", "got"/"ta",
# "can"/"not", "'cause", "'bout", "i." are all real vocab entries)
_EXCEPTIONS = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "gotta": ["got", "ta"],
    "lemme": ["lem", "me"],
    "gimme": ["gim", "me"],
}
for _a in _APOS:
    _EXCEPTIONS[f"c{_a}mon"] = [f"c{_a}m", "on"]
    _EXCEPTIONS[f"{_a}cause"] = [f"{_a}cause"]
    _EXCEPTIONS[f"{_a}bout"] = [f"{_a}bout"]
    _EXCEPTIONS[f"o{_a}clock"] = [f"o{_a}clock"]
for _c in "abcdefghijklmnopqrstuvwxyz":
    # single-letter abbreviations keep the period (spaCy en exceptions
    # "a." .. "z."; vocab evidence: "i.", "o.", "s." are whole tokens)
    _EXCEPTIONS[f"{_c}."] = [f"{_c}."]
for _a in _APOS:
    # already-split exception outputs must round-trip unchanged
    _EXCEPTIONS[f"c{_a}m"] = [f"c{_a}m"]

# contraction suffixes split off with the apostrophe attached
_SUFFIX_RE = re.compile(
    rf"(?:[{_APOS}](?:s|re|ve|ll|d|m)|n[{_APOS}]t)$", re.IGNORECASE)
# plain punctuation suffixes; ellipses/dash-runs come off as ONE token.
# A single trailing hyphen is NOT a spaCy suffix (vocab keeps "you-",
# "the--" whole), so '-' is deliberately absent here.
_PUNCT_SUFFIX_RE = re.compile(r"(?:\.{2,}|[.,!?:;\"\)\]\}%])$")
_PUNCT_PREFIX_RE = re.compile(r"^(?:\.{2,}|[\"\(\[\{$#@.,!?:;])")
# a letter-infix hyphen splits ("peek-a-boo" -> peek - a - boo)
_INFIX_HYPHEN_RE = re.compile(r"(?<=[^\W\d_])(-)(?=[^\W\d_])")
_PUNCT_RUN_RE = re.compile(r"((.)\2*)")


def _tokenize_chunk(chunk: str) -> List[str]:
    """spaCy-style tokenization of one whitespace-delimited chunk."""
    if not chunk:
        return []
    if chunk.lower() in _EXCEPTIONS:
        return list(_EXCEPTIONS[chunk.lower()])
    if not any(c.isalnum() for c in chunk):
        # pure punctuation: runs of the same char form one token
        # ("..." / "--" are single vocab tokens; "?!" splits)
        return [m[0] for m in _PUNCT_RUN_RE.findall(chunk)]
    m = _PUNCT_PREFIX_RE.match(chunk)
    if m:
        return [m.group(0)] + _tokenize_chunk(chunk[m.end():])
    m = _SUFFIX_RE.search(chunk)
    if m and m.start() > 0:
        return _tokenize_chunk(chunk[:m.start()]) + [m.group(0)]
    m = _PUNCT_SUFFIX_RE.search(chunk)
    if m and m.start() > 0:
        return _tokenize_chunk(chunk[:m.start()]) + [m.group(0)]
    parts = _INFIX_HYPHEN_RE.split(chunk)
    if len(parts) > 1:
        return [p for p in parts if p]
    return [chunk]


def _get_spacy():
    global _SPACY_NLP, _SPACY_TRIED
    if not _SPACY_TRIED:
        _SPACY_TRIED = True
        try:
            import spacy
            _SPACY_NLP = spacy.load("en_core_web_sm")
        except Exception:
            _SPACY_NLP = None
    return _SPACY_NLP


def word_tokenize(text: str) -> List[str]:
    nlp = _get_spacy()
    if nlp is not None:
        return [token.text for token in nlp(text)]
    out: List[str] = []
    for chunk in text.split():
        out.extend(_tokenize_chunk(chunk))
    return out


class Tokenizer:
    def __init__(self, vocab: Vocab, max_len: int = MAX_LEN_UTTERANCE):
        self.vocab = vocab
        self.max_len = max_len

    def __call__(self, texts: Union[str, Sequence[str]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """texts -> (tokens [N, max_len] int32, lengths [N] int32).

        Matches MultiModalLitModel.tokenize exactly (multimodal_lit.py:
        161-190): truncate words to max_len-2, wrap in <sos>/<eos>, pad.
        """
        if isinstance(texts, str):
            texts = [texts]
        all_tokens, lengths = [], []
        for text in texts:
            words = word_tokenize(text)[: self.max_len - 2]
            ids = ([SOS_TOKEN_ID] + [self.vocab.get(w) for w in words]
                   + [EOS_TOKEN_ID])
            lengths.append(len(ids))
            ids = ids + [PAD_TOKEN_ID] * (self.max_len - len(ids))
            all_tokens.append(ids)
        return (np.asarray(all_tokens, np.int32),
                np.asarray(lengths, np.int32))

    def encode_utterance(self, utterance: str, max_len: int = None
                         ) -> Tuple[np.ndarray, int]:
        """Training-path encoding: pre-tokenized (space-separated) utterance
        -> <sos> w1 .. wn <eos>, padded/truncated to max_len
        (reference: multimodal_saycam_data_module.py:100-105 + collate
        multimodal_data_module.py:98-109)."""
        max_len = max_len or self.max_len
        words = utterance.split()
        ids = ([SOS_TOKEN_ID] + [self.vocab.get(w) for w in words]
               + [EOS_TOKEN_ID])[:max_len]
        length = len(ids)
        ids = ids + [PAD_TOKEN_ID] * (max_len - length)
        return np.asarray(ids, np.int32), length
