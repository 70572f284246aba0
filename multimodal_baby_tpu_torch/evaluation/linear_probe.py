"""Linear probing of the frozen vision trunk (counterpart of
``multimodal_baby_tpu/evaluation/linear_probe.py``; reference probes:
linear_decoding.py:1-279, object_categories_linear_decoding.py:1-282).

Trunk features are extracted once through the trunk's normal forward (on
the card, its kernel plan) in chunks of 256; the probe (Linear D ->
n_classes, Adam lr 5e-4, cross-entropy: the reference's defaults,
linear_decoding.py:42,60-77) then trains on minibatches drawn with
replacement from an explicit ``torch.Generator``, the same batch and step
count as the JAX package. Subset sweeps and the forced-choice probe eval
(the target-class logit's argmax over a trial's K images,
eval_linear_decoding.py:82-101) are kept.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.data.augment import normalize_image
from multimodal_baby_tpu_torch.models.layers import resolve_device
from multimodal_baby_tpu_torch.models.multimodal import CVCL


@torch.no_grad()
def _in_chunks(fn, images_u8: np.ndarray, device: torch.device,
               batch_size: int) -> np.ndarray:
    chunks = []
    for s in range(0, images_u8.shape[0], batch_size):
        x = normalize_image(torch.from_numpy(
            np.ascontiguousarray(images_u8[s:s + batch_size])).to(device))
        chunks.append(fn(x).float().cpu().numpy())
    return np.concatenate(chunks, axis=0)


def extract_features(model: CVCL, images_u8: np.ndarray,
                     batch_size: int = 256, train: bool = False
                     ) -> np.ndarray:
    """The model's image embeddings [N, E] (normalized as the config says)
    of uint8 images [N, H, W, 3]."""
    device = next(model.parameters()).device
    return _in_chunks(lambda x: model.encode_image(x, train=train)[0],
                      images_u8, device, batch_size)


def extract_backbone_features(model: CVCL, images_u8: np.ndarray,
                              batch_size: int = 256) -> np.ndarray:
    """Raw trunk features before the projection head: the pooled ResNeXt
    (or toy) features, or the ViT's CLS features; the probe input the
    reference uses (linear_decoding.py:60-77)."""
    device = next(model.parameters()).device
    trunk = model.vision_encoder.model

    def feats(x):
        if model.cfg.vision.backbone == "vit_b14":
            return trunk(x)
        return trunk(x)["pooled"]

    return _in_chunks(feats, images_u8, device, batch_size)


def fit_probe(params: Dict[str, torch.Tensor], features: torch.Tensor,
              labels: torch.Tensor, batches: Iterable[torch.Tensor],
              lr: float = 5e-4) -> Dict[str, torch.Tensor]:
    """Adam steps (``torch.optim.Adam``: betas 0.9, 0.999, eps 1e-8, as
    ``optax.adam``) of the mean cross-entropy of ``features @ kernel +
    bias`` from ``params``, one step per index batch of ``batches``."""
    kernel = params["kernel"].detach().clone().requires_grad_(True)
    bias = params["bias"].detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([kernel, bias], lr=lr)
    for idx in batches:
        loss = F.cross_entropy(features[idx] @ kernel + bias, labels[idx])
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {"kernel": kernel.detach(), "bias": bias.detach()}


def train_linear_probe(
    features: np.ndarray,       # [N, D]
    labels: np.ndarray,         # [N] int
    num_classes: int,
    lr: float = 5e-4,           # reference: linear_decoding.py:42
    epochs: int = 100,
    batch_size: int = 128,
    subset_fraction: float = 1.0,
    seed: int = 0,
    device="cuda",
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Returns (probe params {"kernel" [D, C], "bias" [C]} as numpy, final
    train metrics). The subset is drawn as the JAX package draws it
    (``np.random.RandomState(seed)``); the init (U(-1/sqrt(D), 1/sqrt(D))
    kernel, zero bias) and the minibatch indices from a generator seeded
    with ``seed``; ``epochs * max(1, N // batch_size)`` steps."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    n = features.shape[0]
    if subset_fraction < 1.0:
        keep = rng.choice(n, max(1, int(n * subset_fraction)),
                          replace=False)
        features, labels = features[keep], labels[keep]
        n = features.shape[0]

    d = features.shape[1]
    feats = torch.as_tensor(features, dtype=torch.float32, device=device)
    labs = torch.as_tensor(labels, dtype=torch.long, device=device)
    batch_size = min(batch_size, n)
    total_steps = epochs * max(1, n // batch_size)

    gen = torch.Generator().manual_seed(seed)
    k = 1.0 / np.sqrt(d)
    params = {"kernel": (torch.rand(d, num_classes, generator=gen) * (2 * k)
                         - k).to(device),
              "bias": torch.zeros(num_classes, device=device)}
    batches = (torch.randint(0, n, (batch_size,), generator=gen).to(device)
               for _ in range(total_steps))
    params = fit_probe(params, feats, labs, batches, lr)

    with torch.no_grad():
        logits = feats @ params["kernel"] + params["bias"]
        metrics = {"train_ce": float(F.cross_entropy(logits, labs)),
                   "train_acc": float((logits.argmax(-1) == labs)
                                      .float().mean()),
                   "n_train": int(n)}
    return {k: v.cpu().numpy() for k, v in params.items()}, metrics


def half_split(labels: np.ndarray, split: str
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class first/last-half train/test split (reference
    object_categories_linear_decoding.py:58-77): for every class, its
    examples in dataset order are halved; ``split="first"`` trains on the
    first half and tests on the second, ``split="last"`` the reverse.
    Returns (train_indices, test_indices)."""
    if split not in ("first", "last"):
        raise ValueError(f"split must be 'first' or 'last', got {split!r}")
    labels = np.asarray(labels)
    train_idx, test_idx = [], []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        cut = int(len(idx) * 0.5)
        first, last = idx[:cut], idx[cut:]
        if split == "first":
            train_idx.append(first)
            test_idx.append(last)
        else:
            train_idx.append(last)
            test_idx.append(first)
    return np.concatenate(train_idx), np.concatenate(test_idx)


def probe_accuracy(params, features: np.ndarray, labels: np.ndarray
                   ) -> float:
    logits = features @ params["kernel"] + params["bias"]
    return float((logits.argmax(-1) == labels).mean())


def probe_forced_choice(
    params,
    trial_features: np.ndarray,   # [N, K, D] target first
    target_class: np.ndarray,     # [N] class index of the target label
) -> Tuple[float, np.ndarray]:
    """Reference probe eval (eval_linear_decoding.py:82-101): for each trial
    take the target-class logit column over the K images; predict argmax;
    correct iff index 0."""
    logits = trial_features @ params["kernel"] + params["bias"]  # [N, K, C]
    target_logits = np.take_along_axis(
        logits, target_class[:, None, None], axis=2).squeeze(2)  # [N, K]
    preds = target_logits.argmax(-1)
    return float((preds == 0).mean()), preds
