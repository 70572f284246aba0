"""Symmetric InfoNCE of CLIP and CVCL: the mean of the image-to-text and
text-to-image cross-entropies over the B x B logits, the matching pair on
the diagonal."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def loss(logits_per_image: torch.Tensor) -> torch.Tensor:
    labels = torch.arange(logits_per_image.shape[0],
                          device=logits_per_image.device)
    return (F.cross_entropy(logits_per_image, labels)
            + F.cross_entropy(logits_per_image.T, labels)) / 2.0
