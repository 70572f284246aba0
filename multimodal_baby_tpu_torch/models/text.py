"""Text encoder (counterpart of ``multimodal_baby_tpu/models/text.py``),
embedding mode only: the flat embedding is the sum of the token embeddings
over the padded window divided by the true length."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.core.constants import PAD_TOKEN_ID
from multimodal_baby_tpu_torch.models.layers import padding_safe_embed


class TextEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.text.text_encoder != "embedding":
            raise NotImplementedError(
                "the port's text encoder is the embedding mean; got "
                f"{cfg.text.text_encoder!r}")
        self.cfg = cfg
        # torch nn.Embedding init: N(0, 1), PAD row zeroed
        table = torch.randn(cfg.vocab_size, cfg.embedding_dim,
                            generator=generator)
        table[PAD_TOKEN_ID] = 0.0
        self.embedding = nn.Embedding.from_pretrained(
            table.to(device), freeze=False, padding_idx=PAD_TOKEN_ID)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, L] token ids; x_len: [B] lengths. Returns (features
        [B, E], outputs [B, L, E])."""
        embedding = padding_safe_embed(self.embedding.weight, x)
        ret = embedding.sum(dim=1) / x_len.float()[:, None]
        return ret, embedding
