"""Shared layers (counterpart of ``multimodal_baby_tpu/models/layers.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.constants import PAD_TOKEN_ID


class TorchLinear(nn.Linear):
    """``nn.Linear`` with its default init, U(-k, k), k = 1/sqrt(in_dim)
    for weight and bias, drawn from an explicit generator."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(in_dim, out_dim, device=device)
        k = 1.0 / math.sqrt(in_dim)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * k) - k)


def padding_safe_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup with ``nn.Embedding(padding_idx=0)`` semantics:
    lookups of the PAD row pass no gradient to it."""
    return F.embedding(ids, table, padding_idx=PAD_TOKEN_ID)


def length_mask(x_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, L] boolean mask of valid positions."""
    pos = torch.arange(max_len, device=x_len.device)[None, :]
    return pos < x_len[:, None]
