"""CLIP's text tower (Radford et al. 2021; OpenCLIP's ``TextTransformer``)
under the names of the program's text encoder ``"clip"``, float32: token
and learned position embeddings, causal pre-norm blocks (LayerNorm eps
1e-5, one qkv Dense, softmax attention with the later keys masked, a
QuickGELU MLP), the final LayerNorm, the state at each row's end-of-text
token (its largest id, OpenCLIP's argmax), then the bias-free projection
to the embedding.

The widths are ViT-L/14's (``WIDTHS``) unless a sizes dict (a
configuration's ``sizes``) says otherwise. ``quant`` rounds both
operands of every Dense and of the projection (the control's fp8); the
identity is float32."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.quant import identity
from benchmark.reference.weights import Spec

# openai/clip-vit-large-patch14's text_config
WIDTHS = {"text_width": 768, "text_layers": 12, "text_heads": 12,
          "text_mlp_dim": 3072, "ln_eps": 1e-5}


def block_spec(p: str, dim: int, mlp: int) -> Spec:
    """One pre-norm block's leaves (the vision tower's blocks too):
    Denses and their biases N(0, 0.02^2), LayerNorm gains 1 + 0.1 N and
    biases 0.1 N."""
    return [(f"{p}norm1.weight", (dim,), ("scale",)),
            (f"{p}norm1.bias", (dim,), ("shift",)),
            (f"{p}attn.qkv.weight", (3 * dim, dim), ("normal", 0.02)),
            (f"{p}attn.qkv.bias", (3 * dim,), ("normal", 0.02)),
            (f"{p}attn.proj.weight", (dim, dim), ("normal", 0.02)),
            (f"{p}attn.proj.bias", (dim,), ("normal", 0.02)),
            (f"{p}norm2.weight", (dim,), ("scale",)),
            (f"{p}norm2.bias", (dim,), ("shift",)),
            (f"{p}mlp.fc1.weight", (mlp, dim), ("normal", 0.02)),
            (f"{p}mlp.fc1.bias", (mlp,), ("normal", 0.02)),
            (f"{p}mlp.fc2.weight", (dim, mlp), ("normal", 0.02)),
            (f"{p}mlp.fc2.bias", (dim,), ("normal", 0.02))]


def spec(prefix: str, vocab: int, dim: int, max_len: int,
         s: Optional[Dict] = None) -> Spec:
    """The tower's leaves: token embeddings N(0, 0.02^2) and positions
    N(0, 0.01^2) (OpenCLIP's), the blocks as ``block_spec``, the final
    LayerNorm, the projection to ``dim`` U(-k, k), k = 1 / sqrt(width), as
    torch initialises a Linear."""
    s = s or WIDTHS
    p = f"{prefix}text_model."
    d = s["text_width"]
    out: Spec = [
        (f"{p}token_embedding.weight", (vocab, d), ("normal", 0.02)),
        (f"{p}position_embedding.weight", (max_len, d), ("normal", 0.01)),
    ]
    for i in range(s["text_layers"]):
        out += block_spec(f"{p}blocks.{i}.", d, s["text_mlp_dim"])
    out += [(f"{p}final_layer_norm.weight", (d,), ("scale",)),
            (f"{p}final_layer_norm.bias", (d,), ("shift",)),
            (f"{prefix}text_projection.weight", (dim, d),
             ("uniform", 1.0 / math.sqrt(d)))]
    return out


def quick_gelu(h: torch.Tensor) -> torch.Tensor:
    return h * torch.sigmoid(1.702 * h)


def block(w: Dict[str, torch.Tensor], x: torch.Tensor, p: str, heads: int,
          eps: float, causal: bool, quant: Callable) -> torch.Tensor:
    """One pre-norm block on x [B, N, D] (the vision tower's too)."""
    def dense(h, name):
        return F.linear(quant(h), quant(w[f"{p}{name}.weight"]),
                        w[f"{p}{name}.bias"])

    def ln(h, name):
        return F.layer_norm(h, (h.shape[-1],), w[f"{p}{name}.weight"],
                            w[f"{p}{name}.bias"], eps)

    B, N, D = x.shape
    d = D // heads
    qkv = dense(ln(x, "norm1"), "attn.qkv").reshape(B, N, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)          # [B, H, N, d]
    scores = q @ k.transpose(-1, -2) * d ** -0.5
    if causal:
        later = torch.ones(N, N, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(later, float("-inf"))
    ctx = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, N, D)
    x = x + dense(ctx, "attn.proj")
    return x + dense(quick_gelu(dense(ln(x, "norm2"), "mlp.fc1")), "mlp.fc2")


def pooled(w: Dict[str, torch.Tensor], ids: torch.Tensor, prefix: str = "",
           s: Optional[Dict] = None, quant: Callable = identity
           ) -> torch.Tensor:
    """ids [B, L] -> the final LayerNorm's state at the end-of-text token,
    [B, width]."""
    s = s or WIDTHS
    p = f"{prefix}text_model."
    L = ids.shape[1]
    x = (F.embedding(ids, w[f"{p}token_embedding.weight"])
         + w[f"{p}position_embedding.weight"][:L])
    for i in range(s["text_layers"]):
        x = block(w, x, f"{p}blocks.{i}.", s["text_heads"], s["ln_eps"],
                  True, quant)
    x = F.layer_norm(x, (x.shape[-1],), w[f"{p}final_layer_norm.weight"],
                     w[f"{p}final_layer_norm.bias"], s["ln_eps"])
    return x[torch.arange(ids.shape[0], device=ids.device), ids.argmax(-1)]


def project(w: Dict[str, torch.Tensor], h: torch.Tensor, prefix: str = "",
            quant: Callable = identity) -> torch.Tensor:
    return F.linear(quant(h), quant(w[f"{prefix}text_projection.weight"]))

