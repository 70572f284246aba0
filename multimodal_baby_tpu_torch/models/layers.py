"""Shared layers (counterpart of ``multimodal_baby_tpu/models/layers.py``)
and the device rule of the port's entry points."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.constants import PAD_TOKEN_ID
from multimodal_baby_tpu_torch.ops.lstm import (
    kernel_takes, lstm_fused, scan_reference)


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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            mask_shape: Tuple[int, ...] | None = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate). The
    draws come from ``generator`` (on x's device), one per element of
    ``mask_shape`` (default x's shape; a 1 shares a draw along that axis);
    no generator means deterministic (no dropout)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(mask_shape or x.shape, generator=generator,
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def locked_dropout(x: torch.Tensor, rate: float,
                   generator: torch.Generator | None) -> torch.Tensor:
    """Variational dropout (``LockedDropout``) of x [B, L, E]: one mask
    [B, 1, E] shared over time."""
    return dropout(x, rate, generator, (x.shape[0], 1) + x.shape[2:])


class LSTMCellParams(nn.Module):
    """One layer of ``torch.nn.LSTM(input_dim, hidden_dim)``'s parameters
    under its names and layout: ``weight_ih_l0`` [4H, in], ``weight_hh_l0``
    [4H, H], ``bias_ih_l0``, ``bias_hh_l0`` [4H], and the same with the
    suffix ``_reverse`` when ``bidirectional``. Gate order i, f, g, o; init
    U(-k, k), k = 1/sqrt(H), as torch (the JAX package holds the transposed
    weights, ``[in, 4H]``)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 bidirectional: bool = False, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = 1.0 / math.sqrt(hidden_dim)
        h4 = 4 * hidden_dim
        for suffix in ("", "_reverse") if bidirectional else ("",):
            for name, shape in (("weight_ih_l0", (h4, input_dim)),
                                ("weight_hh_l0", (h4, hidden_dim)),
                                ("bias_ih_l0", (h4,)), ("bias_hh_l0", (h4,))):
                w = torch.rand(shape, generator=generator) * (2 * k) - k
                setattr(self, name + suffix, nn.Parameter(w.to(device)))

    def direction(self, reverse: bool = False) -> Tuple[torch.Tensor, ...]:
        """(weight_ih, weight_hh, bias_ih, bias_hh) of one direction."""
        suffix = "_reverse" if reverse else ""
        return tuple(getattr(self, n + suffix) for n in (
            "weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"))


def lstm_gates(pre: torch.Tensor, h_dim: int) -> Tuple[torch.Tensor, ...]:
    """sigmoid(i), sigmoid(f), tanh(g), sigmoid(o) of the [.., 4H]
    pre-activations."""
    i, f, g, o = pre.split(h_dim, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


# The JAX package's length rule: K9 only for windows of at least this many
# steps (at CVCL's 25 the XLA scan was faster on its TPU).
FUSED_LSTM_MIN_LEN = 64


def check_fused_lstm(fused_lstm) -> None:
    """``fused_lstm`` is None (the length rule), True or False."""
    if fused_lstm is not None and not isinstance(fused_lstm, bool):
        raise ValueError(f"fused_lstm must be None, True or False; got "
                         f"{fused_lstm!r}")


def use_fused_lstm(fused_lstm: bool | None, batch: int, length: int,
                   hidden: int) -> bool:
    """Whether ``lstm_scan`` runs K9 (``ops/lstm.py``), the port's form of
    the JAX package's ``_use_fused_lstm`` and ``MMB_FUSED_LSTM``: None, K9
    when ``length >= FUSED_LSTM_MIN_LEN`` and the kernel takes the shape;
    True, K9 at every length (a shape the kernel cannot take raises);
    False, never."""
    check_fused_lstm(fused_lstm)
    if fused_lstm is False:
        return False
    if fused_lstm is None:
        return length >= FUSED_LSTM_MIN_LEN and kernel_takes(batch, hidden)
    if not kernel_takes(batch, hidden):
        raise ValueError(f"fused_lstm=True: the LSTM kernel cannot take "
                         f"B={batch}, H={hidden}")
    return True


def lstm_scan(weight_ih: torch.Tensor, weight_hh: torch.Tensor,
              bias_ih: torch.Tensor, bias_hh: torch.Tensor, x: torch.Tensor,
              mask: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              fused_lstm: bool | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A masked LSTM over the whole padded window (weights in torch layout,
    x [B, L, in], mask [B, L] bool, h0 and c0 [B, H]). Returns (outputs
    [B, L, H], zero at padding; h_last, c_last at each row's last valid
    step), the packed-sequence semantics without packing. The input
    projection of every step is one product; the recurrence is K9
    (``lstm_fused``) where ``use_fused_lstm`` says so, else the plain scan."""
    B, L, _ = x.shape
    H = h0.shape[-1]
    x_proj = (x @ weight_ih.T + bias_ih + bias_hh).transpose(0, 1)
    mask_tm = mask.T.to(x_proj.dtype)
    if use_fused_lstm(fused_lstm, B, L, H):
        out, h_last, c_last = lstm_fused(
            x_proj.float().contiguous(), mask_tm.float().contiguous(),
            weight_hh.T.float().contiguous(), h0.float().contiguous(),
            c0.float().contiguous())
    else:
        out, h_last, c_last = scan_reference(x_proj, mask_tm, weight_hh.T,
                                             h0, c0)
    return out.transpose(0, 1), h_last, c_last


def reverse_padded(x: torch.Tensor, x_len: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence of x [B, L, ...] within its valid length,
    keeping the padding at the end (the biLSTM's backward direction)."""
    L = x.shape[1]
    pos = torch.arange(L, device=x.device)[None, :]
    idx = (x_len[:, None] - 1 - pos).clamp(0, L - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return x.gather(1, idx)


def lstm_step(weight_ih: torch.Tensor, weight_hh: torch.Tensor,
              bias_ih: torch.Tensor, bias_hh: torch.Tensor,
              x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step (decoding, beam search); weights in torch layout."""
    pre = x_t @ weight_ih.T + bias_ih + bias_hh + h @ weight_hh.T
    i, f, g, o = lstm_gates(pre, h.shape[-1])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


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
