"""CLIP's text tower: the forward operations of a caption at the
context's length, the multiply-adds of each causal block's four Denses
and attention's two products (the full L x L, as the kernels compute it
under the causal mask), two each. ``blocks`` counts the vision tower's
blocks too (``counters/clip_vit_l14.py``)."""

from __future__ import annotations

from typing import Dict


def blocks(n: int, width: int, mlp: int, layers: int) -> float:
    """Forward operations of ``layers`` pre-norm blocks over n tokens."""
    dense = n * width * (3 * width + width + 2 * mlp)
    attn = 2 * n * n * width
    return 2.0 * layers * (dense + attn)


def flops(s: Dict) -> float:
    """Forward operations per caption of ``max_len`` tokens."""
    return blocks(s["max_len"], s["text_width"], s["text_mlp_dim"],
                  s["text_layers"])
