"""Shared layers (counterpart of ``multimodal_baby_tpu/models/layers.py``)
and the device rule of the port's entry points."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.constants import PAD_TOKEN_ID


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card unless the caller
    asks for another one. Raises if the card is asked for and there is
    none, rather than running on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return device


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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None
            ) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate). The
    draws come from ``generator`` (on x's device); no generator means
    deterministic (no dropout)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def sinusoidal_pos_embed(max_len: int, dim: int) -> torch.Tensor:
    """Sinusoidal positional embeddings [max_len, dim] (f32)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                         * -(math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class TorchTransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer with the structure and parameter
    names of ``torch.nn.TransformerEncoderLayer(d_model, nhead)`` at its
    defaults (feed-forward 2048, dropout 0.1, ReLU, LayerNorm eps 1e-5):
    ``self_attn.{in_proj_weight, in_proj_bias, out_proj}``, ``linear1``,
    ``linear2``, ``norm1``, ``norm2``. Written as plain ops, as the JAX
    package computes it in XLA. Padded keys are masked with the score
    dtype's most negative finite value; the four dropouts draw from the
    generator passed to ``forward`` (None: deterministic)."""

    def __init__(self, d_model: int, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        self.self_attn = nn.Module()
        # torch's init: xavier-uniform in_proj, zero in_proj and out_proj bias
        bound = math.sqrt(6.0 / (d_model + 3 * d_model))
        self.self_attn.in_proj_weight = nn.Parameter(
            ((torch.rand(3 * d_model, d_model, generator=generator) * 2 - 1)
             * bound).to(device))
        self.self_attn.in_proj_bias = nn.Parameter(
            torch.zeros(3 * d_model, device=device))
        self.self_attn.out_proj = TorchLinear(d_model, d_model, device=device,
                                              generator=generator)
        with torch.no_grad():
            self.self_attn.out_proj.bias.zero_()
        self.linear1 = TorchLinear(d_model, dim_feedforward, device=device,
                                   generator=generator)
        self.linear2 = TorchLinear(dim_feedforward, d_model, device=device,
                                   generator=generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, L, E]; key_padding_mask: [B, L], True at PAD (masked)."""
        B, L, E = x.shape
        H = self.nhead
        attn_mod = self.self_attn
        qkv = F.linear(x, attn_mod.in_proj_weight, attn_mod.in_proj_bias)
        q, k, v = (t.reshape(B, L, H, E // H).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        scores = q @ k.transpose(-1, -2) / math.sqrt(E // H)
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
        attn = dropout(scores.softmax(-1), self.dropout, generator)
        ctx = (attn @ v).transpose(1, 2).reshape(B, L, E)
        ctx = dropout(attn_mod.out_proj(ctx), self.dropout, generator)
        x = self.norm1(x + ctx)
        ff = dropout(torch.relu(self.linear1(x)), self.dropout, generator)
        ff = dropout(self.linear2(ff), self.dropout, generator)
        return self.norm2(x + ff)
