"""A CVCL step's model operations, composed from the counters of its
trunk (``counters/<architecture>.py``) and text encoder
(``counters/text_<encoder>.py``), found by name.

A train step counts the frozen trunk's forward, the head's forward and
its weight gradient (the trunk's output takes none), the text encoder's
forward and backward (twice its forward), and the similarity's forward
and backward; the augment, the loss's elementwise work and AdamW are not
counted. An embedding step counts the trunk's and the head's forward."""

from __future__ import annotations

from benchmark.harness import load_module


def _parts(cfg: dict):
    return (load_module("counters", cfg["architecture"]),
            load_module("counters", f"text_{cfg['text_encoder']}"))


def trunk_flops(cfg: dict, batch: int) -> float:
    trunk, _ = _parts(cfg)
    return batch * trunk.flops(cfg["sizes"]["image_px"])


def trunk_bytes(cfg: dict, batch: int) -> float:
    trunk, _ = _parts(cfg)
    return trunk.bytes_per_batch(batch, cfg["sizes"]["image_px"])


def train_step_flops(cfg: dict, batch: int) -> float:
    trunk, text = _parts(cfg)
    s = cfg["sizes"]
    e = s["embedding_dim"]
    head = 2.0 * batch * trunk.OUT_DIM * e
    sim = 2.0 * batch * batch * e
    return (trunk_flops(cfg, batch) + 2 * head
            + 3 * text.flops(batch, s["max_len"], e) + 3 * sim)


def embed_flops(cfg: dict, batch: int) -> float:
    trunk, _ = _parts(cfg)
    return trunk_flops(cfg, batch) + 2.0 * batch * trunk.OUT_DIM \
        * cfg["sizes"]["embedding_dim"]
