"""The CVCL transformer text encoder (Vong et al. 2024; the reference
repository's ``TextEncoder`` with ``text_encoder="transformer"``),
float32: the token embeddings (``text_embedding``'s lookup) plus learned
positions through one post-norm ``nn.TransformerEncoderLayer`` (8 heads,
feed-forward 2048, ReLU, LayerNorm eps 1e-5, dropout 0.1 at four places
in training, padding keys masked), then the embedding encoder's mean over
the window.

The dropouts take their uniform draws from ``draw(shape)``; None means no
dropout."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import text_embedding
from benchmark.reference.text_embedding import PAD
from benchmark.reference.weights import Spec

HEADS = 8
FF = 2048
DROPOUT = 0.1
LN_EPS = 1e-5


def spec(prefix: str, vocab: int, dim: int, max_len: int) -> Spec:
    p = prefix
    out = text_embedding.spec(prefix, vocab, dim, max_len)
    q = f"{p}transformer_encoder.layers.0."
    xav = math.sqrt(6.0 / (dim + 3 * dim))
    out += [(f"{p}pos_embed", (max_len, 1, dim), ("normal", 0.02)),
            (f"{q}self_attn.in_proj_weight", (3 * dim, dim), ("uniform", xav)),
            (f"{q}self_attn.in_proj_bias", (3 * dim,), ("normal", 0.02)),
            (f"{q}self_attn.out_proj.weight", (dim, dim),
             ("uniform", 1 / math.sqrt(dim))),
            (f"{q}self_attn.out_proj.bias", (dim,), ("normal", 0.02)),
            (f"{q}linear1.weight", (FF, dim), ("uniform", 1 / math.sqrt(dim))),
            (f"{q}linear1.bias", (FF,), ("uniform", 1 / math.sqrt(dim))),
            (f"{q}linear2.weight", (dim, FF), ("uniform", 1 / math.sqrt(FF))),
            (f"{q}linear2.bias", (dim,), ("uniform", 1 / math.sqrt(FF))),
            (f"{q}norm1.weight", (dim,), ("scale",)),
            (f"{q}norm1.bias", (dim,), ("shift",)),
            (f"{q}norm2.weight", (dim,), ("scale",)),
            (f"{q}norm2.bias", (dim,), ("shift",))]
    return out


def _drop(x: torch.Tensor, draw: Optional[Callable]) -> torch.Tensor:
    if draw is None:
        return x
    keep = draw(x.shape) >= DROPOUT
    return torch.where(keep, x / (1.0 - DROPOUT), 0.0)


def encode(w: Dict[str, torch.Tensor], ids: torch.Tensor,
           lens: torch.Tensor, prefix: str = "",
           draw: Optional[Callable] = None) -> torch.Tensor:
    """ids [B, L], lens [B] -> the flat text feature [B, dim]."""
    p = prefix
    x = text_embedding.lookup(w, ids, p)
    B, L, E = x.shape
    q = f"{p}transformer_encoder.layers.0."
    x = x + w[f"{p}pos_embed"][:L, 0][None]
    qkv = F.linear(x, w[f"{q}self_attn.in_proj_weight"],
                   w[f"{q}self_attn.in_proj_bias"])
    qh, kh, vh = (t.reshape(B, L, HEADS, E // HEADS).transpose(1, 2)
                  for t in qkv.chunk(3, dim=-1))
    s = qh @ kh.transpose(-1, -2) / math.sqrt(E // HEADS)
    s = s.masked_fill((ids == PAD)[:, None, None, :], float("-inf"))
    a = _drop(s.softmax(-1), draw)
    ctx = (a @ vh).transpose(1, 2).reshape(B, L, E)
    ctx = _drop(F.linear(ctx, w[f"{q}self_attn.out_proj.weight"],
                         w[f"{q}self_attn.out_proj.bias"]), draw)
    x = F.layer_norm(x + ctx, (E,), w[f"{q}norm1.weight"],
                     w[f"{q}norm1.bias"], LN_EPS)
    h = _drop(torch.relu(F.linear(x, w[f"{q}linear1.weight"],
                                  w[f"{q}linear1.bias"])), draw)
    h = _drop(F.linear(h, w[f"{q}linear2.weight"], w[f"{q}linear2.bias"]),
              draw)
    x = F.layer_norm(x + h, (E,), w[f"{q}norm2.weight"],
                     w[f"{q}norm2.bias"], LN_EPS)
    return text_embedding.mean_over_window(x, lens)
