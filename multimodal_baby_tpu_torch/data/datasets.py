"""Forced-choice trial datasets over the reference's JSON-metadata format
(counterpart of the eval half of ``multimodal_baby_tpu/data/datasets.py``:
``load_metadata``, the image loader, ``EvalTrialDataset`` and
``TextEvalTrialDataset``; a test holds the items equal).

Eval trials: ``{"data": [{"target_img_filename": str,
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
from typing import List

import numpy as np

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, IMAGE_H, MAX_LEN_UTTERANCE, PAD_TOKEN_ID, SOS_TOKEN_ID)
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
