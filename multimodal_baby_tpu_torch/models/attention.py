"""Additive (Bahdanau) attention over a spatial image feature map
(counterpart of ``multimodal_baby_tpu/models/attention.py``), with feature
maps channels-last ([B, h, w, D]) as the JAX package keeps them. Parameter
names follow the reference: ``encoder_projection``, ``decoder_projection``,
``attn_layer`` (torch ``Linear`` layout)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.models.layers import TorchLinear

_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh}


def additive_attention(enc_flat: torch.Tensor, proj_enc_flat: torch.Tensor,
                       decoder_features: torch.Tensor,
                       dec_weight: torch.Tensor, dec_bias: torch.Tensor,
                       attn_weight: torch.Tensor, attn_bias: torch.Tensor,
                       activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_flat [B, S, D_enc], proj_enc_flat [B, S, A], decoder_features
    [B, D_dec]; returns (attended features [B, D_enc], attns [B, S])."""
    proj_dec = F.linear(decoder_features, dec_weight, dec_bias)
    act = _ACTIVATIONS[activation]
    scores = (act(proj_enc_flat + proj_dec[:, None, :])
              @ attn_weight.T).squeeze(-1) + attn_bias
    attns = torch.softmax(scores, dim=-1)
    return torch.einsum("bsd,bs->bd", enc_flat, attns), attns


class AdditiveAttention(nn.Module):
    def __init__(self, encoder_dim: int, decoder_dim: int, attn_dim: int,
                 activation: str = "relu", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"attention activation must be one of "
                             f"{tuple(_ACTIVATIONS)}; got {activation!r}")
        self.attn_dim = attn_dim
        self.activation = activation
        self.encoder_projection = TorchLinear(encoder_dim, attn_dim,
                                              device=device,
                                              generator=generator)
        self.decoder_projection = TorchLinear(decoder_dim, attn_dim,
                                              device=device,
                                              generator=generator)
        self.attn_layer = TorchLinear(attn_dim, 1, device=device,
                                      generator=generator)

    def project_encoder_features(self, encoder_features: torch.Tensor
                                 ) -> torch.Tensor:
        """[B, ..., D_enc] -> [B, ..., attn_dim], once per sequence (hoisted
        out of the decode loop)."""
        return self.encoder_projection(encoder_features)

    def forward(self, encoder_features: torch.Tensor,
                projected_encoder_features: torch.Tensor,
                decoder_features: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (attended features [B, D_enc], attns [B, ...])."""
        B = encoder_features.shape[0]
        spatial = encoder_features.shape[1:-1]
        features, attns = additive_attention(
            encoder_features.reshape(B, -1, encoder_features.shape[-1]),
            projected_encoder_features.reshape(B, -1, self.attn_dim),
            decoder_features, self.decoder_projection.weight,
            self.decoder_projection.bias, self.attn_layer.weight,
            self.attn_layer.bias, self.activation)
        return features, attns.reshape((B,) + spatial)
