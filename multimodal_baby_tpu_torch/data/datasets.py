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

Frames are decoded on the host in the JAX package's order: the native
C++ decoder (``data/native``: libjpeg and libpng, bilinear resize, the
DCT-scaled JPEG decode when ``fast_decode``) first, PIL (bicubic resize)
where the library is not built or a file does not decode. A training
batch is decoded in one call of the decoder's thread pool. The frames stay
uint8; the augment and the normalization run on the device
(``data/augment.py``).
"""

from __future__ import annotations

import json
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, IMAGE_H, MAX_LEN_UTTERANCE, PAD_TOKEN_ID, SOS_TOKEN_ID)
from multimodal_baby_tpu_torch.data import native
from multimodal_baby_tpu_torch.data.tokenizer import Tokenizer
from multimodal_baby_tpu_torch.data.vocab import Vocab


def load_metadata(path) -> List[dict]:
    with open(path) as f:
        return json.load(f)["data"]


def load_image_uint8(path: str, size: int = IMAGE_H,
                     fast: bool = True) -> np.ndarray:
    """Decode to [size, size, 3] uint8, resized if needed: with the native
    decoder (``fast``: its DCT-scaled JPEG decode), else with PIL (bicubic
    resize), as the JAX package's ``_load_image_uint8``."""
    out = native.decode_image(path, size, fast)
    if out is not None:
        return out
    from PIL import Image
    with Image.open(path) as src:
        img = src.convert("RGB")
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
    draws, so a seed gives the same pairs in both packages.
    ``fast_decode``: the native decoder's DCT-scaled JPEG decode (the JAX
    package's default, ``MMB_FAST_DECODE=1``)."""

    def __init__(self, data: List[dict], vocab: Vocab,
                 multiple_frames: bool = False,
                 shuffle_utterances: bool = False,
                 max_len: int = MAX_LEN_UTTERANCE, seed: int = 0,
                 fast_decode: bool = True):
        self.data = data
        self.fast_decode = fast_decode
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
        img = load_image_uint8(self.frame_filename(img_entry),
                               fast=self.fast_decode)
        utterance = txt_entry["utterance"]
        ids, length = self.tokenizer.encode_utterance(utterance)
        return img, ids, length, utterance

    def batch_frames(self, idxs) -> List[str]:
        """The frame file of each item of ``idxs``, in order (with
        ``multiple_frames``, the batch's random draws). The loader calls it
        on its own thread in batch order, so that threads that build
        batches at once draw the same frames as a loop would."""
        return [self.frame_filename(self.data[int(j)]) for j in idxs]

    def batch_items(self, idxs, frames: Optional[List[str]] = None
                    ) -> Dict[str, np.ndarray]:
        """The collated batch of the items ``idxs`` with the frame files
        ``frames`` (drawn here when not given): every frame decoded in one
        call of the native decoder's thread pool, the utterances tokenized
        in a loop. A frame the decoder does not read (a corrupt file, a
        format other than JPEG and PNG) goes through PIL, with one warning
        for the batch; a file neither reads raises. Without the native
        library, every frame goes through PIL."""
        paths = self.batch_frames(idxs) if frames is None else list(frames)
        decoded = native.decode_batch_checked(paths, IMAGE_H,
                                              fast=self.fast_decode)
        if decoded is None:
            imgs = np.stack([load_image_uint8(p, IMAGE_H, self.fast_decode)
                             for p in paths])
        else:
            imgs, ok = decoded
            if not ok.all():
                failed = np.flatnonzero(ok == 0)
                warnings.warn(
                    f"native decode failed for {len(failed)} of "
                    f"{len(paths)} frames (e.g. {paths[failed[0]]}); "
                    "falling back to PIL for those slots")
                for i in failed:
                    imgs[i] = load_image_uint8(paths[int(i)], IMAGE_H,
                                               self.fast_decode)
        n = len(idxs)
        text = np.empty((n, self.max_len), np.int32)
        lens = np.empty((n,), np.int32)
        raws = []
        for i, j in enumerate(idxs):
            utterance = self.data[self.utterance_order[int(j)]]["utterance"]
            text[i], lens[i] = self.tokenizer.encode_utterance(utterance)
            raws.append(utterance)
        return {"image_u8": imgs, "text": text, "text_len": lens,
                "raw": raws}


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
    target category). ``fast_decode`` as ``PairedImageTextDataset``'s."""

    def __init__(self, data: List[dict], vocab: Vocab,
                 eval_include_sos_eos: bool = False,
                 fast_decode: bool = True):
        self.data = data
        self.vocab = vocab
        self.eval_include_sos_eos = eval_include_sos_eos
        self.fast_decode = fast_decode

    def __len__(self):
        return len(self.data)

    def n_imgs(self) -> int:
        return len(self.data[0]["foil_img_filenames"]) + 1

    def __getitem__(self, idx):
        trial = self.data[idx]
        filenames = [trial["target_img_filename"]] + \
            list(trial["foil_img_filenames"])
        imgs = np.stack([load_image_uint8(f, fast=self.fast_decode)
                         for f in filenames])
        label = _label_ids(self.vocab, trial["target_category"],
                           self.eval_include_sos_eos)
        ids = np.full((MAX_LEN_UTTERANCE,), PAD_TOKEN_ID, np.int32)
        ids[:len(label)] = label
        return imgs, ids, len(label), trial["target_category"]


class TextEvalTrialDataset:
    """Text mode: one image, target + foil labels
    (multimodal_data_module.py:163-214). An item is (image [H, W, 3]
    uint8, label ids [K, 25], label lengths [K], target category).
    ``fast_decode`` as ``PairedImageTextDataset``'s."""

    def __init__(self, data: List[dict], vocab: Vocab,
                 eval_include_sos_eos: bool = False,
                 fast_decode: bool = True):
        self.data = data
        self.vocab = vocab
        self.eval_include_sos_eos = eval_include_sos_eos
        self.fast_decode = fast_decode

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        trial = self.data[idx]
        img = load_image_uint8(trial["target_img_filename"],
                               fast=self.fast_decode)
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
