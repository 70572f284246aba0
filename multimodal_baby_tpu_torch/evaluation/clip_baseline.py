"""The CLIP baseline of the forced-choice evals (counterpart of
``multimodal_baby_tpu/evaluation/clip_baseline.py``; the reference compares
CVCL against OpenAI CLIP: ViT-L/14 in eval.py:29-47, ViT-B/16 for the
eval-frame filter).

The JAX package runs Hugging Face ``transformers`` CLIP on the CPU; the
port runs its own towers (``models/clip.py``: the vision blocks on K5 and
K6 in bf16) and tokenizer (``data/clip_tokenizer.py``) from the same model
directory (``api/hf_dir.py``), on the card unless the caller passes
``device="cpu"``. The adapter has the JAX module's contract: target first,
argmax over K, labels ``"a photo of a {category}"``, batches of 16 trials.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.constants import CLIP_MEAN, CLIP_STD
from multimodal_baby_tpu_torch.data.clip_tokenizer import CLIPTokenizer
from multimodal_baby_tpu_torch.models.clip import load_clip


class CLIPBaseline:
    """score_image_trials over a CLIP model (the port's ``CLIPModel``;
    None: ``load_clip(model_name, device=device, dtype=dtype,
    kernels=kernels)``) and the tokenizer of ``processor_name`` or
    ``model_name``."""

    def __init__(self, model=None, processor_name: Optional[str] = None,
                 model_name: str = "openai/clip-vit-large-patch14",
                 load_tokenizer: bool = True, *, device="cuda",
                 dtype: torch.dtype | None = None, kernels=None):
        if model is None:
            model = load_clip(model_name, device=device, dtype=dtype,
                              kernels=kernels)
        self.model = model.eval()
        self.device = model.device
        self.tokenizer = None
        if load_tokenizer:
            self.tokenizer = CLIPTokenizer.from_pretrained(
                processor_name or model_name)

    # ---- encoding ----

    def preprocess(self, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 NHWC -> CLIP-normalized NCHW f32 on the model's device,
        resized bicubically to the model's input size (reference
        transforms: multimodal_data_module.py:256-267)."""
        size = self.model.image_size
        x = torch.as_tensor(np.asarray(images_u8)).to(self.device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        if x.shape[-1] != size:
            x = F.interpolate(x, (size, size), mode="bicubic",
                              align_corners=False)
        mean = torch.tensor(CLIP_MEAN, device=self.device).view(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=self.device).view(1, 3, 1, 1)
        return (x - mean) / std

    def encode_image(self, images_u8: np.ndarray) -> np.ndarray:
        f = self.model.get_image_features(self.preprocess(images_u8))
        return (f / f.norm(dim=-1, keepdim=True)).cpu().numpy()

    def encode_text(self, texts: List[str]) -> np.ndarray:
        assert self.tokenizer is not None, "no tokenizer available"
        f = self.model.get_text_features(**self.tokenizer(texts))
        return (f / f.norm(dim=-1, keepdim=True)).cpu().numpy()

    # ---- forced choice ----

    def score_image_trials(self, trial_images_u8: np.ndarray,
                           labels: List[str]) -> np.ndarray:
        """[N, K, H, W, 3] uint8 + N label strings -> logits [N, K]."""
        n, k = trial_images_u8.shape[:2]
        img = self.encode_image(
            trial_images_u8.reshape((-1,) + trial_images_u8.shape[2:]))
        txt = self.encode_text(labels)
        return np.einsum("nkd,nd->nk", img.reshape(n, k, -1), txt)


def run_clip_forced_choice(baseline: CLIPBaseline, dataset,
                           batch_size: int = 16):
    """Forced-choice accuracy and per-trial records of a CLIP baseline over
    an ``EvalTrialDataset`` (reference: eval.py's clip_eval branch)."""
    correct = []
    records = []
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in
                 range(start, min(start + batch_size, len(dataset)))]
        imgs = np.stack([it[0] for it in items])
        labels = [f"a photo of a {it[3]}" for it in items]
        preds = baseline.score_image_trials(imgs, labels).argmax(-1)
        for j, it in enumerate(items):
            ok = bool(preds[j] == 0)
            correct.append(ok)
            records.append({"pred": int(preds[j]), "correct": ok,
                            "category": it[3]})
    return float(np.mean(correct)), records
