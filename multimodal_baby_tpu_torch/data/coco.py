"""A copy of ``multimodal_baby_tpu/data/coco.py`` (tests hold the prepared
files and the items of the two equal), kept so that the port imports
nothing of the JAX package; images decode with the port's
``datasets.load_image_uint8``.

MS COCO Captions (Karpathy split) data module.

Capability parity with the reference COCO module
(multimodal/coco_captions_data_module.py:41-276): vocabulary built from all
captions with count > 5 (ids ordered by (count, token) descending, special
tokens 0-3), per-image caption lists with token ids, train/val/test by the
Karpathy ``split`` field, random-caption-per-image option.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List

import numpy as np

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, MAX_LEN_UTTERANCE, PAD_TOKEN_ID, SOS_TOKEN_ID,
    SPECIAL_TOKENS, UNK_TOKEN_ID)
from multimodal_baby_tpu_torch.data.datasets import load_image_uint8
from multimodal_baby_tpu_torch.data.vocab import Vocab


def build_coco_vocab(karpathy: dict, count_threshold: int = 5) -> Vocab:
    """count > threshold, ids by (count, token) descending after specials
    (reference: coco_captions_data_module.py:156-232)."""
    counts: Counter = Counter()
    for image in karpathy["images"]:
        for sent in image["sentences"]:
            counts.update(sent["tokens"])
    count_tokens = sorted(((c, t) for t, c in counts.items()), reverse=True)
    vocab_tokens = list(SPECIAL_TOKENS) + [
        t for c, t in count_tokens if c > count_threshold]
    return Vocab({t: i for i, t in enumerate(vocab_tokens)})


def prepare_coco(data_dir, karpathy_json, count_threshold: int = 5) -> None:
    """Karpathy dataset_coco.json -> vocab.json + {train,val,test}.json
    (idempotent)."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    vocab_path = data_dir / "vocab.json"
    if all((data_dir / f"{s}.json").exists()
           for s in ("train", "val", "test")) and vocab_path.exists():
        return

    with open(karpathy_json) as f:
        karpathy = json.load(f)

    vocab = build_coco_vocab(karpathy, count_threshold)
    vocab.save(vocab_path)

    splits: Dict[str, List[dict]] = {"train": [], "val": [], "test": []}
    for image in karpathy["images"]:
        # karpathy "restval" images join train (standard practice)
        split = image["split"] if image["split"] in splits else "train"
        sentences = []
        for sent in image["sentences"]:
            sentences.append({
                "tokens": sent["tokens"],
                "token_ids": [vocab.get(t) for t in sent["tokens"]],
            })
        splits[split].append({
            "filename": image.get("filename",
                                  image.get("file_name", "")),
            "filepath": image.get("filepath", ""),
            "sentences": sentences,
        })
    for split, images in splits.items():
        with open(data_dir / f"{split}.json", "w") as f:
            json.dump({"images": images}, f)


class COCOCaptionsDataset:
    """(image, caption) pairs; one (or a random) caption per image
    (reference: coco_captions_data_module.py:41-89). Items are
    (img_uint8 [224,224,3], ids [25], length, raw_captions)."""

    def __init__(self, data: dict, image_dir, multiple_captions: bool = False,
                 max_len: int = MAX_LEN_UTTERANCE, seed: int = 0):
        self.images = data["images"]
        self.image_dir = Path(image_dir)
        self.multiple_captions = multiple_captions
        self.max_len = max_len
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        image = self.images[idx]
        sentences = image["sentences"]
        raw_captions = [" ".join(s["tokens"]) for s in sentences]
        sent = (sentences[self.rng.randint(len(sentences))]
                if self.multiple_captions else sentences[0])
        ids = [SOS_TOKEN_ID] + list(sent["token_ids"]) + [EOS_TOKEN_ID]
        ids = ids[:self.max_len]
        length = len(ids)
        padded = np.full((self.max_len,), PAD_TOKEN_ID, np.int32)
        padded[:length] = ids
        path = self.image_dir / image.get("filepath", "") / image["filename"]
        img = load_image_uint8(str(path))
        return img, padded, length, raw_captions
