"""Dataset assembly from config (counterpart of
``multimodal_baby_tpu/data/modules.py``): the reference's
LightningDataModule filename contract relative to ``data_dir``
(multimodal_saycam_data_module.py:40-62): train.json /
train_shuffled.json / val.json / test.json, eval_*_{dev,test}.json,
vocab.json. A "synthetic" dataset serves benchmarks and smoke tests.

``prepare_data`` builds such a directory from raw inputs with the offline
ETL (``data/etl.py``), or a COCO directory from ``dataset_coco.json`` (the
Karpathy split, ``data/coco.py``). For COCO, ``setup`` builds
``COCOCaptionsDataset`` splits from ``{train,val,test}.json``, the images
found under ``data_dir`` by each entry's ``filepath`` and ``filename``
(the COCO root's ``train2014/``, ``val2014/``), a random caption per
image in the train split with ``multiple_frames``; COCO has no
forced-choice trials.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from multimodal_baby_tpu_torch.core.config import DataConfig
from multimodal_baby_tpu_torch.data.coco import (
    COCOCaptionsDataset, prepare_coco)
from multimodal_baby_tpu_torch.data.datasets import (
    EvalTrialDataset, PairedImageTextDataset, SyntheticPairedDataset,
    TextEvalTrialDataset, load_metadata)
from multimodal_baby_tpu_torch.data.etl import prepare_data
from multimodal_baby_tpu_torch.data.vocab import Vocab


class DataModule:
    """Holds the vocab, the train/val/test paired datasets and the
    eval-trial datasets. ``fast_decode``: the native decoder's DCT-scaled
    JPEG decode in every dataset (``data/native``; on by default, as the
    JAX package's ``MMB_FAST_DECODE``)."""

    def __init__(self, cfg: DataConfig, vocab_size_hint: int = 2350,
                 seed: int = 0, fast_decode: bool = True):
        self.cfg = cfg
        self.seed = seed
        self.fast_decode = fast_decode
        self.data_dir = Path(cfg.data_dir)
        self.vocab: Optional[Vocab] = None
        self.datasets: Dict[str, object] = {}
        self.eval_datasets: Dict[str, object] = {}
        self._vocab_size_hint = vocab_size_hint

    def prepare_data(self) -> "DataModule":
        """Run the offline ETL when raw inputs are configured (reference
        multimodal_saycam_data_module.py:159-176), or prepare COCO from
        ``data_dir/dataset_coco.json``. Every step skips when its output
        exists, so a prepared ``data_dir`` is a no-op."""
        c = self.cfg
        if c.dataset == "saycam":
            prepare_data(
                self.data_dir,
                transcript_dir=c.transcript_dir,
                video_dir=c.video_dir,
                labeled_s_dir=c.labeled_s_dir,
                transcript_links_csv=c.transcript_links_csv,
                seed=self.seed)
        elif c.dataset == "coco":
            karpathy = self.data_dir / "dataset_coco.json"
            if karpathy.exists():
                prepare_coco(self.data_dir, karpathy)
        return self

    def setup(self) -> "DataModule":
        c = self.cfg
        if c.dataset == "coco":
            self.vocab = Vocab.load(self.data_dir / "vocab.json")
            for split in ("train", "val", "test"):
                path = self.data_dir / f"{split}.json"
                if path.exists():
                    with open(path) as f:
                        self.datasets[split] = COCOCaptionsDataset(
                            json.load(f), self.data_dir,
                            multiple_captions=(c.multiple_frames
                                               and split == "train"),
                            seed=self.seed)
            return self
        if c.dataset == "synthetic":
            self.vocab = Vocab({f"w{i}": i for i in range(
                self._vocab_size_hint)})
            for split, n in (("train", c.synthetic_size),
                             ("val", max(8, c.synthetic_size // 8)),
                             ("test", max(8, c.synthetic_size // 8))):
                self.datasets[split] = SyntheticPairedDataset(
                    n, len(self.vocab), seed=self.seed)
            return self

        self.vocab = Vocab.load(self.data_dir / "vocab.json")

        train_file = ("train_shuffled.json" if c.shuffle_utterances
                      else "train.json")
        for split, fname in (("train", train_file), ("val", "val.json"),
                             ("test", "test.json")):
            path = self.data_dir / fname
            if path.exists():
                self.datasets[split] = PairedImageTextDataset(
                    load_metadata(path), self.vocab,
                    multiple_frames=c.multiple_frames and split == "train",
                    shuffle_utterances=False,  # pairing handled by file
                    seed=self.seed, fast_decode=self.fast_decode)

        dev_name = c.eval_metadata_filename
        test_name = dev_name.replace("dev", "test")
        cls = (EvalTrialDataset if c.eval_type == "image"
               else TextEvalTrialDataset)
        for split, fname in (("val", dev_name), ("test", test_name)):
            path = self.data_dir / fname
            if path.exists():
                self.eval_datasets[split] = cls(
                    load_metadata(path), self.vocab,
                    eval_include_sos_eos=c.eval_include_sos_eos,
                    fast_decode=self.fast_decode)
        return self

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
