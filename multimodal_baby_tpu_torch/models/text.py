"""Text encoder (counterpart of ``multimodal_baby_tpu/models/text.py``), in
two of its modes:

- ``embedding``: the token embeddings;
- ``transformer``: the token embeddings plus a positional embedding
  (learned, sinusoidal or none) through one post-norm transformer encoder
  layer (8 heads, feed-forward 2048, dropout 0.1 in training), PAD keys
  masked.

The flat embedding is the sum of the outputs over the whole padded window
divided by the true length (the reference's semantics: padded query
positions contribute to the sum). Parameter names follow the reference:
``embedding.weight``, ``transformer_encoder.layers.0.*``, ``pos_embed``
(learned only, ``[25, 1, E]``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.core.constants import (
    MAX_LEN_UTTERANCE, PAD_TOKEN_ID)
from multimodal_baby_tpu_torch.models.layers import (
    TorchTransformerEncoderLayer, padding_safe_embed, resolve_device,
    sinusoidal_pos_embed)

_ARCHS = ("embedding", "transformer")
_POS_EMBEDS = ("no_pos_embed", "learned", "sinusoidal")


class TextEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        t = cfg.text
        if t.text_encoder not in _ARCHS:
            raise NotImplementedError(
                f"the port's text encoders are {_ARCHS}; got "
                f"{t.text_encoder!r}")
        if t.dropout_i or t.dropout_o or t.captioning or t.attention:
            raise NotImplementedError(
                "the port's text encoder has no LSTM dropouts, captioning "
                "or attention")
        if t.pos_embed_type not in _POS_EMBEDS:
            raise ValueError(f"pos_embed_type must be one of {_POS_EMBEDS}; "
                             f"got {t.pos_embed_type!r}")
        device = resolve_device(device)
        self.cfg = cfg
        E = cfg.embedding_dim
        # torch nn.Embedding init: N(0, 1), PAD row zeroed
        table = torch.randn(cfg.vocab_size, E, generator=generator)
        table[PAD_TOKEN_ID] = 0.0
        self.embedding = nn.Embedding.from_pretrained(
            table.to(device), freeze=False, padding_idx=PAD_TOKEN_ID)
        if t.text_encoder == "transformer":
            self.transformer_encoder = nn.Module()
            self.transformer_encoder.layers = nn.ModuleList([
                TorchTransformerEncoderLayer(E, nhead=8, device=device,
                                             generator=generator)])
            if t.pos_embed_type == "learned":
                self.pos_embed = nn.Parameter(
                    torch.zeros(MAX_LEN_UTTERANCE, 1, E, device=device))
            elif t.pos_embed_type == "sinusoidal":
                self.register_buffer(
                    "pos_embed",
                    sinusoidal_pos_embed(MAX_LEN_UTTERANCE, E)[:, None]
                    .to(device), persistent=False)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, L] token ids; x_len: [B] lengths; ``generator`` draws the
        transformer's dropout (None: deterministic, as in eval). Returns
        (features [B, E], outputs [B, L, E])."""
        output = padding_safe_embed(self.embedding.weight, x)
        if self.cfg.text.text_encoder == "transformer":
            if hasattr(self, "pos_embed"):
                output = output + self.pos_embed[None, :x.shape[1], 0]
            layer = self.transformer_encoder.layers[0]
            output = layer(output, x == PAD_TOKEN_ID, generator)
        return output.sum(dim=1) / x_len.float()[:, None], output
