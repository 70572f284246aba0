"""The losses (counterpart of ``multimodal_baby_tpu/models/losses.py``):
symmetric InfoNCE, the LM cross-entropy and the attention regulariser."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, PAD_TOKEN_ID, SOS_TOKEN_ID)


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


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     weight: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokenwise CE of logits [B, L, V] against labels [B, L], PAD ignored
    (``ignore_index``); ``weight`` [V] weights each class. Returns (ce
    [B, L], zero at PAD; mask [B, L])."""
    ce = cross_entropy_with_int_labels(logits, labels)
    if weight is not None:
        ce = ce * weight[labels]
    mask = labels != PAD_TOKEN_ID
    return torch.where(mask, ce, 0.0), mask


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def lm_loss_breakdown(ce: torch.Tensor, labels: torch.Tensor,
                      reduce: Callable[[torch.Tensor], torch.Tensor]
                      = _identity) -> Dict[str, torch.Tensor]:
    """Means of ``ce`` over the tokens, then without SOS, then without SOS
    and EOS, with the token counts. ``reduce`` sums each sum and count
    over the data group on a mesh (``parallel/collectives.py::
    all_reduce``), making the means those of the global batch."""
    mask = labels != PAD_TOKEN_ID
    n = reduce(mask.sum())
    out = {"ce_loss": reduce(ce.sum()) / n, "n_tokens": n}
    mask = mask & (labels != SOS_TOKEN_ID)
    n = reduce(mask.sum())
    out.update(ce_loss_wo_sos=reduce((ce * mask).sum()) / n,
               n_tokens_wo_sos=n)
    mask = mask & (labels != EOS_TOKEN_ID)
    n = reduce(mask.sum())
    out.update(ce_loss_wo_sos_eos=reduce((ce * mask).sum()) / n,
               n_tokens_wo_sos_eos=n)
    return out


def attn_reg_loss(attns: torch.Tensor,
                  reduce: Callable[[torch.Tensor], torch.Tensor] = _identity
                  ) -> torch.Tensor:
    """((sum over steps of attn - 1)^2).mean(): each spatial position's
    total attention over the utterance near 1. ``reduce`` as
    ``lm_loss_breakdown``'s."""
    sq = (attns.sum(dim=1) - 1.0) ** 2
    if reduce is _identity:
        return sq.mean()
    return reduce(sq.sum()) / reduce(torch.tensor(
        float(sq.numel()), device=sq.device))
