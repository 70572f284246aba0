"""A copy of ``multimodal_baby_tpu/data/object_categories.py`` (a test
holds the two equal), kept so that the port imports nothing of the JAX
package.

Konkle-style object-categories evaluation data
(reference: multimodal/object_categories_data_module.py).

Out-of-distribution zero-shot eval: clean object stimuli on white
backgrounds, categories filtered to the SAYCam vocab, 5 trials per image
with n_foils foil categories. Trials reuse the generic forced-choice
datasets/harness; this module provides stimulus prep + trial generation.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from multimodal_baby_tpu_torch.core.constants import IMAGE_H, IMAGE_W
from multimodal_baby_tpu_torch.data.vocab import Vocab


def get_object_categories(data_dir, vocab: Vocab) -> List[str]:
    """Category subdirectories present in the vocab
    (reference: object_categories_data_module.py:202-214)."""
    return sorted(d.name for d in Path(data_dir).iterdir()
                  if d.is_dir() and d.name in vocab)


def resize_object_images(data_dir, out_dir,
                         categories: Sequence[str]) -> None:
    """Shrink stimuli to 50% and paste centered on a white 224x224 canvas
    (reference: object_categories_data_module.py:229-246)."""
    from PIL import Image

    out_dir = Path(out_dir)
    for cat in categories:
        (out_dir / cat).mkdir(parents=True, exist_ok=True)
        for img_path in sorted(Path(data_dir, cat).glob("*.jpg")):
            img = Image.open(img_path).resize(
                (IMAGE_W // 2, IMAGE_H // 2), Image.BICUBIC)
            canvas = Image.new("RGB", (IMAGE_W, IMAGE_H), "white")
            canvas.paste(img, (IMAGE_W // 4, IMAGE_H // 4))
            canvas.save(out_dir / cat / img_path.name)


def create_object_categories_metadata(
    data_dir, out_path, vocab: Vocab,
    n_trials_per_image: int = 5, n_foils: int = 3, seed: int = 0,
    categories: Optional[Sequence[str]] = None,
) -> int:
    """Generate forced-choice trials: every image of every in-vocab
    category is a target n_trials_per_image times with freshly sampled
    foils (reference: object_categories_data_module.py:248-297)."""
    rng = np.random.RandomState(seed)
    data_dir = Path(data_dir)
    cats = list(categories or get_object_categories(data_dir, vocab))
    trials = []
    idx = 0
    for target in cats:
        for img_path in sorted(data_dir.joinpath(target).glob("*.jpg")) \
                + sorted(data_dir.joinpath(target).glob("*.png")):
            for _ in range(n_trials_per_image):
                foils = list(rng.choice(
                    [c for c in cats if c != target], size=n_foils,
                    replace=False))
                foil_files = []
                for c in foils:
                    imgs = sorted(data_dir.joinpath(c).glob("*.jpg")) \
                        + sorted(data_dir.joinpath(c).glob("*.png"))
                    foil_files.append(str(imgs[rng.randint(len(imgs))]))
                trials.append({
                    "trial_num": idx,
                    "target_category": target,
                    "target_img_filename": str(img_path),
                    "foil_categories": foils,
                    "foil_img_filenames": foil_files,
                })
                idx += 1
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"data": trials}, f)
    return len(trials)
