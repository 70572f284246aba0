"""Contrastive loss (counterpart of ``multimodal_baby_tpu/models/losses.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def get_entropy(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of softmax(logits)."""
    logp = torch.log_softmax(logits, dim=dim)
    return -(logp.exp() * logp).sum(dim=dim)


def cross_entropy_with_int_labels(logits: torch.Tensor, labels: torch.Tensor
                                  ) -> torch.Tensor:
    """Per-example CE: logsumexp - true logit."""
    lse = torch.logsumexp(logits, dim=-1)
    true = logits.gather(-1, labels[..., None]).squeeze(-1)
    return lse - true


def contrastive_loss_from_logits(
    logits_per_image: torch.Tensor, logits_per_text: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over the B x B similarity matrix with accuracy and
    entropy diagnostics. ``valid`` (bool [B]) marks real rows of a padded
    tail batch: padded rows leave the row means and the negative pool."""
    n = logits_per_image.shape[0]
    labels = torch.arange(n, device=logits_per_image.device)
    if valid is None:
        w = torch.ones(n, dtype=logits_per_image.dtype,
                       device=logits_per_image.device)
    else:
        w = valid.to(logits_per_image.dtype)
        col_mask = torch.where(valid, 0.0, -1e9).to(logits_per_image.dtype)
        logits_per_image = logits_per_image + col_mask[None, :]
        logits_per_text = logits_per_text + col_mask[None, :]
    # max(., 1): an all-padding batch contributes weight 0, not NaN
    denom = w.sum().clamp_min(1.0)

    def wmean(x):
        return (x * w).sum() / denom

    loss_i = wmean(cross_entropy_with_int_labels(logits_per_image, labels))
    loss_t = wmean(cross_entropy_with_int_labels(logits_per_text, labels))
    infonce = (loss_i + loss_t) / 2.0

    metrics = {
        "image_accuracy": wmean(
            (logits_per_image.argmax(dim=-1) == labels).to(w.dtype)),
        "text_accuracy": wmean(
            (logits_per_text.argmax(dim=-1) == labels).to(w.dtype)),
        "image_entropy": wmean(get_entropy(logits_per_image)),
        "text_entropy": wmean(get_entropy(logits_per_text)),
    }
    return infonce, metrics
