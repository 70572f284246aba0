"""Datasets over the reference's JSON-metadata format (counterpart of
``multimodal_baby_tpu/data/datasets.py``: ``load_metadata``, the image
loader, ``PairedImageTextDataset``, ``SyntheticPairedDataset``,
``EvalTrialDataset`` and ``TextEvalTrialDataset``; tests hold the items
equal).

Training metadata: ``{"data": [{"utterance": str, "frame_filenames" or
"frame_filename": ...}]}`` (reference: multimodal_saycam_data_module.py:
77-211). Eval trials: ``{"data": [{"target_img_filename": str,
"foil_img_filenames": [str], "target_category": str, "foil_categories":
[str]}]}`` (reference: multimodal_data_module.py:112-214).

Images are decoded with PIL only. The JAX package prefers its native C++
decoder (``multimodal_baby_tpu/data/native``), whose resize is bilinear
where PIL's is bicubic: the two agree exactly on frames already at 224 px
and differ on frames that need a resize. Copying the native decoder's
sources into the port waits for the host input path (ROADMAP Queue 1,
item 5).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, IMAGE_H, MAX_LEN_UTTERANCE, PAD_TOKEN_ID, SOS_TOKEN_ID)
from multimodal_baby_tpu_torch.data.loader import collate
from multimodal_baby_tpu_torch.data.tokenizer import Tokenizer
from multimodal_baby_tpu_torch.data.vocab import Vocab


def load_metadata(path) -> List[dict]:
    with open(path) as f:
        return json.load(f)["data"]


def load_image_uint8(path: str, size: int = IMAGE_H) -> np.ndarray:
    """Decode to [size, size, 3] uint8 with PIL, bicubic resize if needed."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, np.uint8)


class PairedImageTextDataset:
    """(image, utterance) pairs for contrastive and LM training, with
    MultiModalSAYCamDataset's semantics (multimodal_saycam_data_module.py:
    77-124): a random frame per utterance when ``multiple_frames``,
    <sos>/<eos> wrapping, UNK fallback, and the ``shuffle_utterances``
    ablation (the pairing broken by a fixed permutation). The frame choice
    and the permutation are the JAX package's ``np.random.RandomState``
    draws, so a seed gives the same pairs in both packages."""

    def __init__(self, data: List[dict], vocab: Vocab,
                 multiple_frames: bool = False,
                 shuffle_utterances: bool = False,
                 max_len: int = MAX_LEN_UTTERANCE, seed: int = 0):
        self.data = data
        self.tokenizer = Tokenizer(vocab, max_len)
        self.multiple_frames = multiple_frames
        self.max_len = max_len
        self.rng = np.random.RandomState(seed)
        self.utterance_order = np.arange(len(data))
        if shuffle_utterances:
            self.utterance_order = np.random.RandomState(
                seed).permutation(len(data))

    def __len__(self) -> int:
        return len(self.data)

    def frame_filename(self, entry: dict) -> str:
        if "frame_filenames" in entry:
            names = entry["frame_filenames"]
            if self.multiple_frames:
                return names[self.rng.randint(len(names))]
            return names[0]
        return entry["frame_filename"]

    def __getitem__(self, idx: int
                    ) -> Tuple[np.ndarray, np.ndarray, int, str]:
        img_entry = self.data[idx]
        txt_entry = self.data[self.utterance_order[idx]]
        img = load_image_uint8(self.frame_filename(img_entry))
        utterance = txt_entry["utterance"]
        ids, length = self.tokenizer.encode_utterance(utterance)
        return img, ids, length, utterance

    def batch_items(self, idxs) -> Dict[str, np.ndarray]:
        """A collated batch of the items ``idxs``, decoded one by one with
        PIL. The JAX package decodes a whole batch in one call of its
        native C++ decoder when that is built; porting it waits for the
        host input path (ROADMAP Queue 1, item 5)."""
        return collate([self[int(j)] for j in idxs])


class SyntheticPairedDataset:
    """Deterministic synthetic pairs for benchmarks and smoke tests: no
    disk, no decode. The arrays are the JAX package's draws for a seed."""

    def __init__(self, size: int, vocab_size: int,
                 max_len: int = MAX_LEN_UTTERANCE, seed: int = 0,
                 image_size: int = IMAGE_H):
        rng = np.random.RandomState(seed)
        self.images = rng.randint(
            0, 256, (size, image_size, image_size, 3), np.uint8)
        lens = rng.randint(1, max_len - 1, size)
        self.text = np.zeros((size, max_len), np.int32)
        self.text[:, 0] = SOS_TOKEN_ID
        for i, n in enumerate(lens):
            self.text[i, 1:1 + n] = rng.randint(4, vocab_size, n)
            self.text[i, 1 + n] = EOS_TOKEN_ID
        self.text_len = (lens + 2).astype(np.int32)

    def __len__(self):
        return self.images.shape[0]

    def __getitem__(self, idx):
        return (self.images[idx], self.text[idx],
                int(self.text_len[idx]), "")


def _label_ids(vocab: Vocab, category: str, include_sos_eos: bool
               ) -> List[int]:
    label = [vocab[category]]
    if include_sos_eos:
        label = [SOS_TOKEN_ID] + label + [EOS_TOKEN_ID]
    return label


class EvalTrialDataset:
    """4-way forced-choice trials, image mode: one label, target + N foil
    images, target always index 0 (multimodal_data_module.py:112-161).
    An item is (images [K, H, W, 3] uint8, label ids [25], label length,
    target category)."""

    def __init__(self, data: List[dict], vocab: Vocab,
                 eval_include_sos_eos: bool = False):
        self.data = data
        self.vocab = vocab
        self.eval_include_sos_eos = eval_include_sos_eos

    def __len__(self):
        return len(self.data)

    def n_imgs(self) -> int:
        return len(self.data[0]["foil_img_filenames"]) + 1

    def __getitem__(self, idx):
        trial = self.data[idx]
        filenames = [trial["target_img_filename"]] + \
            list(trial["foil_img_filenames"])
        imgs = np.stack([load_image_uint8(f) for f in filenames])
        label = _label_ids(self.vocab, trial["target_category"],
                           self.eval_include_sos_eos)
        ids = np.full((MAX_LEN_UTTERANCE,), PAD_TOKEN_ID, np.int32)
        ids[:len(label)] = label
        return imgs, ids, len(label), trial["target_category"]


class TextEvalTrialDataset:
    """Text mode: one image, target + foil labels
    (multimodal_data_module.py:163-214). An item is (image [H, W, 3]
    uint8, label ids [K, 25], label lengths [K], target category)."""

    def __init__(self, data: List[dict], vocab: Vocab,
                 eval_include_sos_eos: bool = False):
        self.data = data
        self.vocab = vocab
        self.eval_include_sos_eos = eval_include_sos_eos

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        trial = self.data[idx]
        img = load_image_uint8(trial["target_img_filename"])
        raw_labels = [trial["target_category"]] + \
            list(trial["foil_categories"])
        ids = np.full((len(raw_labels), MAX_LEN_UTTERANCE),
                      PAD_TOKEN_ID, np.int32)
        lens = np.zeros((len(raw_labels),), np.int32)
        for i, lab in enumerate(raw_labels):
            label = _label_ids(self.vocab, lab, self.eval_include_sos_eos)
            ids[i, :len(label)] = label
            lens[i] = len(label)
        return img, ids, lens, trial["target_category"]
