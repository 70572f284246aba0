"""CLIP ViT-L/14's train step: its model operations and the vision
tower's bytes, from the configuration's ``sizes`` (the same whatever
implements a layer). Operations are the multiply-adds of the patch
convolution, each block's four Denses and attention's two products, the
two projections and the similarity, two each (the text tower's:
``counters/text_clip.py``); LayerNorm, softmax, GELU, the augment, the
loss's elementwise work and AdamW are not counted.

A train step counts three times the forward of both towers, the
projections and the similarity (forward and backward). The vision
tower's backward (``PlainVJP`` in every block) is counted as twice its
forward: the forward it recomputes is not model work."""

from __future__ import annotations

from typing import Dict

from benchmark.counters import text_clip
from benchmark.counters.text_clip import blocks


def tokens(s: Dict) -> int:
    return (s["image_px"] // s["patch"]) ** 2 + 1


def flops(s: Dict) -> float:
    """The vision tower's forward operations per frame (to the class
    token's ``post_layernorm``)."""
    n, c, p = tokens(s), s["width"], s["patch"]
    return 2.0 * (n - 1) * c * 3 * p * p + blocks(n, c, s["mlp_dim"],
                                                  s["layers"])


def trunk_flops(cfg: dict, batch: int) -> float:
    return batch * flops(cfg["sizes"])


def trunk_bytes(cfg: dict, batch: int) -> float:
    """The vision tower's forward: input frames (bf16), the blocks'
    weights (bf16) and the class features (f32), each once."""
    s = cfg["sizes"]
    c, f, p = s["width"], s["mlp_dim"], s["patch"]
    weights = c * 3 * p * p + s["layers"] * (4 * c * c + 2 * c * f)
    return float(batch * s["image_px"] ** 2 * 3 * 2 + weights * 2
                 + batch * c * 4)


def trunk_vjp_flops(cfg: dict, batch: int) -> float:
    """The vision tower's backward: twice its forward."""
    return 2.0 * trunk_flops(cfg, batch)


def trunk_vjp_bytes(cfg: dict, batch: int) -> float:
    """The blocks' backward (bf16), each once: per half-block its saved
    input, the gradient in and the gradient out ([B, N, width] each), its
    weights read and their gradients written."""
    s = cfg["sizes"]
    c, f = s["width"], s["mlp_dim"]
    acts = 2 * 3 * batch * tokens(s) * c
    weights = 2 * (4 * c * c + 2 * c * f)
    return float(s["layers"] * (acts + weights) * 2)


def train_step_flops(cfg: dict, batch: int) -> float:
    s = cfg["sizes"]
    e = s["embedding_dim"]
    heads = 2.0 * batch * e * (s["width"] + s["text_width"])
    sim = 2.0 * batch * batch * e
    return 3 * (trunk_flops(cfg, batch) + batch * text_clip.flops(s)
                + heads + sim)
