"""Dataset assembly from config (counterpart of
``multimodal_baby_tpu/data/modules.py``): the reference's
LightningDataModule filename contract relative to ``data_dir``
(multimodal_saycam_data_module.py:40-62): train.json /
train_shuffled.json / val.json / test.json, eval_*_{dev,test}.json,
vocab.json. A "synthetic" dataset serves benchmarks and smoke tests.

Not ported: the offline ETL that builds such a directory from raw
transcripts and videos, and the COCO captions dataset (ROADMAP Queue 1,
item 7); each refuses with a message.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from multimodal_baby_tpu_torch.core.config import DataConfig
from multimodal_baby_tpu_torch.data.datasets import (
    EvalTrialDataset, PairedImageTextDataset, SyntheticPairedDataset,
    TextEvalTrialDataset, load_metadata)
from multimodal_baby_tpu_torch.data.vocab import Vocab

_NOT_PORTED = ("is not ported: the ETL and the COCO dataset wait for "
               "ROADMAP Queue 1, item 7; prepare the data directory with "
               "the JAX package (python -m multimodal_baby_tpu.cli.train "
               "--prepare_data_only ...)")


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
        """Nothing to do for a prepared directory or synthetic data.
        Raw inputs (transcripts, videos, Labeled-S frames) and COCO need
        the ETL, which the port refuses."""
        c = self.cfg
        raw = {k: getattr(c, k) for k in (
            "transcript_dir", "video_dir", "labeled_s_dir",
            "transcript_links_csv") if getattr(c, k)}
        if c.dataset == "coco":
            raise NotImplementedError(f"dataset 'coco' {_NOT_PORTED}")
        if raw:
            raise NotImplementedError(
                f"prepare_data from raw inputs ({', '.join(sorted(raw))}) "
                f"{_NOT_PORTED}")
        return self

    def setup(self) -> "DataModule":
        c = self.cfg
        if c.dataset == "coco":
            raise NotImplementedError(f"dataset 'coco' {_NOT_PORTED}")
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
