"""DINO ViT-B/14 (Caron et al. 2021; the ``dino_vitb14``-style layout and
names): a 14x14 patch convolution, a CLS token, learned positions for 257
tokens at 224 px, 12 pre-norm blocks of width 768 with 12 heads, qkv
bias, an MLP of 3072 with the exact (erf) GELU, LayerNorm eps 1e-6, and
the final LayerNorm of the CLS token. Float32; rows in blocks so that a
large batch fits.

``quant`` rounds both operands of the patch convolution and of every
Dense (the control's fp8); the identity is float32."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from benchmark.reference.quant import identity
from benchmark.reference.weights import Spec

PATCH = 14
DIM = 768
DEPTH = 12
HEADS = 12
MLP = 3072
LN_EPS = 1e-6
OUT_DIM = DIM
HEAD = "head"   # the projection head's leaves: <prefix>head.weight, .bias


def tokens(px: int) -> int:
    return (px // PATCH) ** 2 + 1


def spec(prefix: str, px: int = 224) -> Spec:
    p = prefix
    k = 1.0 / math.sqrt(3 * PATCH * PATCH)
    out: Spec = [
        (f"{p}cls_token", (1, 1, DIM), ("normal", 0.02)),
        (f"{p}pos_embed", (1, tokens(px), DIM), ("normal", 0.02)),
        (f"{p}patch_embed.proj.weight", (DIM, 3, PATCH, PATCH),
         ("uniform", k)),
        (f"{p}patch_embed.proj.bias", (DIM,), ("uniform", k)),
    ]
    for i in range(DEPTH):
        q = f"{p}blocks.{i}."
        out += [(f"{q}norm1.weight", (DIM,), ("scale",)),
                (f"{q}norm1.bias", (DIM,), ("shift",)),
                (f"{q}attn.qkv.weight", (3 * DIM, DIM), ("normal", 0.02)),
                (f"{q}attn.qkv.bias", (3 * DIM,), ("normal", 0.02)),
                (f"{q}attn.proj.weight", (DIM, DIM), ("normal", 0.02)),
                (f"{q}attn.proj.bias", (DIM,), ("normal", 0.02)),
                (f"{q}norm2.weight", (DIM,), ("scale",)),
                (f"{q}norm2.bias", (DIM,), ("shift",)),
                (f"{q}mlp.fc1.weight", (MLP, DIM), ("normal", 0.02)),
                (f"{q}mlp.fc1.bias", (MLP,), ("normal", 0.02)),
                (f"{q}mlp.fc2.weight", (DIM, MLP), ("normal", 0.02)),
                (f"{q}mlp.fc2.bias", (DIM,), ("normal", 0.02))]
    out += [(f"{p}norm.weight", (DIM,), ("scale",)),
            (f"{p}norm.bias", (DIM,), ("shift",))]
    return out


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def _rows(w: Dict[str, torch.Tensor], x_nhwc: torch.Tensor, prefix: str,
          quant: Callable) -> torch.Tensor:
    p = prefix

    def dense(x, name):
        return F.linear(quant(x), quant(w[f"{p}{name}.weight"]),
                        w[f"{p}{name}.bias"])

    x = x_nhwc.permute(0, 3, 1, 2).float()
    patches = F.conv2d(quant(x), quant(w[f"{p}patch_embed.proj.weight"]),
                       w[f"{p}patch_embed.proj.bias"], stride=PATCH)
    B = patches.shape[0]
    t = patches.flatten(2).transpose(1, 2)
    t = torch.cat([w[f"{p}cls_token"].expand(B, 1, DIM), t], dim=1)
    t = t + w[f"{p}pos_embed"]
    N = t.shape[1]
    d = DIM // HEADS
    for i in range(DEPTH):
        q = f"blocks.{i}."
        h = _ln(t, w[f"{p}{q}norm1.weight"], w[f"{p}{q}norm1.bias"])
        qkv = dense(h, f"{q}attn.qkv").reshape(B, N, 3, HEADS, d)
        qh, kh, vh = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        a = (qh @ kh.transpose(-1, -2) * d ** -0.5).softmax(-1)
        ctx = (a @ vh).transpose(1, 2).reshape(B, N, DIM)
        t = t + dense(ctx, f"{q}attn.proj")
        h = _ln(t, w[f"{p}{q}norm2.weight"], w[f"{p}{q}norm2.bias"])
        h = F.gelu(dense(h, f"{q}mlp.fc1"))
        t = t + dense(h, f"{q}mlp.fc2")
    return _ln(t[:, 0], w[f"{p}norm.weight"], w[f"{p}norm.bias"])


def forward(w: Dict[str, torch.Tensor], x_nhwc: torch.Tensor,
            batch_stats: bool = False, prefix: str = "",
            quant: Callable = identity, block_rows: int = 128
            ) -> torch.Tensor:
    """x [B, 224, 224, 3] float32 -> the CLS feature [B, 768]
    (``batch_stats`` is unused: the ViT has no BatchNorm)."""
    return torch.cat([_rows(w, x_nhwc[i:i + block_rows], prefix, quant)
                      for i in range(0, x_nhwc.shape[0], block_rows)])
