"""Zero-shot forced-choice evaluation (Labeled-S / object-categories;
counterpart of ``multimodal_baby_tpu/evaluation/forced_choice.py``).

Trials are scored a chunk of ``batch_size`` at a time: a chunk's n x K
images go through the trunk in one call (image mode) or its n x K labels
through the text encoder in one call (text mode), and each trial's K
logits are formed from its own features: a batched product for flat
embeddings, ``spatial_similarity`` per trial for spatial ones. That is the
JAX package's per-trial ``model.apply`` (``forced_choice.py:38-49``) with
the trials batched; its semantics are kept: labels cut to the chunk's
longest true length (the transformer encoder is not padding-invariant),
the kitty swap as the JAX package does it, probabilities in float64,
target index 0, and the reference's predictions-JSON schema
(eval.py:248-266).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.constants import SOS_TOKEN_ID
from multimodal_baby_tpu_torch.data.augment import normalize_image
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.models.multimodal import CVCL


def _score_chunk(model: CVCL, images: np.ndarray, labels: np.ndarray,
                 lens: np.ndarray, eval_type: str) -> torch.Tensor:
    """Logits [n, K] of n trials. Image mode: images [n, K, H, W, 3] uint8,
    one label [n, L] of length [n] per trial (the logits_per_text row,
    multimodal_lit.py:474-476). Text mode: one image [n, H, W, 3] per
    trial, labels [n, K, L] of lengths [n, K] (the logits_per_image
    row)."""
    device = next(model.parameters()).device
    x = normalize_image(torch.from_numpy(images).to(device))
    y = torch.from_numpy(labels).to(device, torch.long)
    y_len = torch.from_numpy(lens).to(device, torch.long)
    n, K = labels.shape[0], (images.shape[1] if eval_type == "image"
                             else labels.shape[1])
    if eval_type == "image":
        img, _ = model.encode_image(x.flatten(0, 1))
        txt, _ = model.encode_text(y, y_len)
        img = img.unflatten(0, (n, K))
    else:
        img, _ = model.encode_image(x)
        txt, _ = model.encode_text(y.flatten(0, 1), y_len.flatten())
        txt = txt.unflatten(0, (n, K))
    if model.cfg.embedding_type == "flat":
        eq = "nke,ne->nk" if eval_type == "image" else "ne,nke->nk"
        match = torch.einsum(eq, img, txt)
    elif eval_type == "image":
        match = torch.stack([
            model.similarity(img[j], txt[j:j + 1], y_len[j:j + 1])[:, 0]
            for j in range(n)])
    else:
        match = torch.stack([
            model.similarity(img[j:j + 1], txt[j], y_len[j])[0]
            for j in range(n)])
    return match * model.logit_scale()


@torch.no_grad()
def run_forced_choice(
    model: CVCL,
    dataset,
    eval_type: str = "image",
    batch_size: int = 64,
    use_kitty_label: bool = False,
    vocab: Optional[Vocab] = None,
) -> Tuple[Dict[str, float], List[dict]]:
    """Returns (per-class + total accuracies, trial records) of ``model``
    (on its device) over ``dataset`` (``data/datasets.py``'s
    ``EvalTrialDataset`` in image mode, ``TextEvalTrialDataset`` in text
    mode, or any sequence of their items).

    ``use_kitty_label`` swaps the 'cat' label for 'kitty' at eval time
    (reference: eval.py:163-194). As in the JAX package, image mode writes
    after a leading <sos> and text mode at position 0 whatever is there.
    """
    if eval_type not in ("image", "text"):
        raise ValueError(f"eval_type must be image|text, got {eval_type!r}")
    n = len(dataset)
    correct_pred: Dict[str, int] = {}
    total_pred: Dict[str, int] = {}
    records: List[dict] = []

    for start in range(0, n, batch_size):
        idxs = range(start, min(start + batch_size, n))
        items = [dataset[i] for i in idxs]
        cats = [it[3] for it in items]
        images = np.stack([it[0] for it in items])
        if eval_type == "image":
            labels = np.stack([it[1] for it in items])        # [n, L]
            lens = np.asarray([it[2] for it in items])        # [n]
        else:
            labels = np.stack([it[1] for it in items])        # [n, K, L]
            lens = np.stack([it[2] for it in items])          # [n, K]
        # score at the true label length, not the padded window
        # (multimodal_data_module.py:145-150): the transformer encoder
        # is not padding-invariant
        labels = labels[..., :max(1, int(lens.max()))].copy()
        if use_kitty_label and vocab is not None:
            for j, c in enumerate(cats):
                if c != "cat":
                    continue
                if eval_type == "image":
                    pos = 1 if labels[j, 0] == SOS_TOKEN_ID else 0
                    labels[j, pos] = vocab["kitty"]
                else:
                    labels[j, 0, 0] = vocab["kitty"]
        logits = _score_chunk(model, images, labels, lens, eval_type)

        logits = logits.double().cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        preds = logits.argmax(-1)

        for j, (i, cat) in enumerate(zip(idxs, cats)):
            label_name = "kitty" if (use_kitty_label and cat == "cat") \
                else cat
            correct = bool(preds[j] == 0)  # target is always index 0
            correct_pred[label_name] = correct_pred.get(label_name, 0) \
                + int(correct)
            total_pred[label_name] = total_pred.get(label_name, 0) + 1
            trial = getattr(dataset, "data", [None] * (i + 1))[i]
            categories = ([trial["target_category"]]
                          + list(trial.get("foil_categories", []))
                          if isinstance(trial, dict) else [cat])
            records.append({
                "trial_idx": i,
                "categories": categories,
                "logits": probs[j].tolist(),
                "pred": int(preds[j]),
                "correct": correct,
                "eval_type": eval_type,
            })

    accuracies = {
        c: correct_pred[c] / total_pred[c] for c in sorted(total_pred)}
    accuracies["total"] = (
        sum(correct_pred.values()) / max(1, sum(total_pred.values())))
    return accuracies, records


def save_predictions(records: List[dict], path, extra_fields: dict = None):
    """Write the predictions JSON with run provenance merged into every
    record (schema of eval.py:248-266)."""
    extra_fields = extra_fields or {}
    out = [dict(extra_fields, **r) for r in records]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"data": out}, f)


def print_accuracy_table(accuracies: Dict[str, float]) -> None:
    for name, acc in accuracies.items():
        if name != "total":
            print(f"Accuracy for class {name:12s}: {acc:.1%}")
    print(f"Total accuracy: {accuracies['total']:.1%}")
