"""DINO ViT-B/14's operations and bytes from its layer shapes. Operations
are the multiply-adds of the patch convolution, the four Denses of each
block and attention's two products, two each; LayerNorm, softmax and GELU
are not counted. Bytes are the input, the weights and the output, each
once."""

from __future__ import annotations

PATCH, DIM, DEPTH, HEADS, MLP = 14, 768, 12, 12, 3072
OUT_DIM = DIM


def tokens(px: int) -> int:
    return (px // PATCH) ** 2 + 1


def flops(px: int) -> float:
    """Forward operations per frame."""
    n = tokens(px)
    patch = (n - 1) * DIM * 3 * PATCH * PATCH
    dense = n * DIM * (3 * DIM + DIM + MLP + MLP)
    attn = 2 * n * n * DIM
    return 2.0 * (patch + DEPTH * (dense + attn))


def weight_elems() -> int:
    block = DIM * 3 * DIM + DIM * DIM + 2 * DIM * MLP
    return DIM * 3 * PATCH * PATCH + DEPTH * block


def bytes_per_batch(batch: int, px: int) -> float:
    """Input frames (bf16), weights (bf16), the CLS features (f32)."""
    return float(batch * px * px * 3 * 2 + weight_elems() * 2
                 + batch * DIM * 4)
