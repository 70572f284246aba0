"""CVCL (Vong et al. 2024, Science): a frozen vision trunk, a trainable
linear head to the embedding, a trainable text encoder, L2-normalised
features, and the symmetric InfoNCE at a fixed temperature, trained with
AdamW. Float32 with TF32 off; ``quant`` rounds the augment's and the
trunk's products, the parts the configurations run in bf16 (the
control).

The configuration's file (``benchmark/configs/<name>.json``) gives the
trunk (``architecture``), the text encoder, the widths and the optimizer;
the leaves carry the names of the reference repository's checkpoints.
Both parts are found by name: the trunk's reference is
``reference/<architecture>.py`` (``spec(prefix, px)``, ``forward``,
``OUT_DIM``, ``HEAD``), the text encoder's ``reference/text_<encoder>.py``
(``spec(prefix, vocab, dim, max_len)``, ``encode``)."""

from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import adamw, augment, infonce
from benchmark.reference.quant import identity
from benchmark.reference.weights import Spec

TRUNK_PREFIX = "vision_encoder.model."
TEXT_PREFIX = "text_encoder."


def set_precision() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def trunk_of(cfg: dict) -> ModuleType:
    """The reference of the configuration's trunk."""
    return importlib.import_module(
        f"benchmark.reference.{cfg['architecture']}")


def text_of(cfg: dict) -> ModuleType:
    """The reference of the configuration's text encoder."""
    return importlib.import_module(
        f"benchmark.reference.text_{cfg['text_encoder']}")


def model_spec(cfg: dict) -> Spec:
    s = cfg["sizes"]
    trunk = trunk_of(cfg)
    out = trunk.spec(TRUNK_PREFIX, s["image_px"])
    head = f"{TRUNK_PREFIX}{trunk.HEAD}"
    k = 1.0 / math.sqrt(trunk.OUT_DIM)
    out += [(f"{head}.weight", (s["embedding_dim"], trunk.OUT_DIM),
             ("uniform", k)),
            (f"{head}.bias", (s["embedding_dim"],), ("uniform", k))]
    out += text_of(cfg).spec(TEXT_PREFIX, s["vocab_size"],
                             s["embedding_dim"], s["max_len"])
    out += [("language_model.output_layer.bias", (s["vocab_size"],),
             ("zeros",))]
    return out


def trainable(cfg: dict, names: Sequence[str]) -> List[str]:
    """The leaves AdamW updates: everything but the frozen trunk, whose
    projection head stays trainable."""
    head = f"{TRUNK_PREFIX}{trunk_of(cfg).HEAD}."
    return [n for n in names
            if not n.startswith(TRUNK_PREFIX) or n.startswith(head)]


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def image_features(cfg: dict, w: Dict[str, torch.Tensor],
                   x: torch.Tensor, batch_stats: bool,
                   quant: Callable = identity
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised image features [B, E], the trunk's features) of
    normalised frames x; the head reads ``w`` (which may hold leaves that
    take gradients)."""
    trunk = trunk_of(cfg)
    with torch.no_grad():
        pooled = trunk.forward(w, x, batch_stats, TRUNK_PREFIX, quant)
    head = f"{TRUNK_PREFIX}{trunk.HEAD}"
    return _normalise(F.linear(pooled, w[f"{head}.weight"],
                               w[f"{head}.bias"])), pooled


def embed(cfg: dict, w: Dict[str, torch.Tensor], frames_u8: np.ndarray,
          device, quant: Callable = identity) -> torch.Tensor:
    """The embeddings of uint8 frames, BatchNorm on running statistics."""
    x = augment.normalise(torch.from_numpy(frames_u8).to(device))
    with torch.no_grad():
        return image_features(cfg, w, x, False, quant)[0]


def train(cfg: dict, w: Dict[str, torch.Tensor], batches: Sequence[dict],
          gen: torch.Generator, device, quant: Callable = identity,
          half_batch: bool = False
          ) -> Tuple[List[float], Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor], torch.Tensor]:
    """Train steps on the host ``batches`` (``image_u8``, ``text``,
    ``text_len``), the augment and the dropouts drawn from ``gen`` in the
    configuration's order. Returns (each step's loss, the first step's
    gradient of every trainable leaf, the trainable leaves after the last
    step, the first step's trunk features). ``half_batch`` (a fault to read) leaves out the second half of
    each batch and takes the loss's mean over the rest."""
    exp = cfg["experiment"]
    opt = cfg["optimizer"]
    s = cfg["sizes"]
    text = text_of(cfg)
    names = trainable(cfg, list(w))
    params = {n: w[n].clone() for n in names}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    scale = 1.0 / exp["model"]["temperature"]
    batch_stats = exp["model"]["vision"].get("frozen_bn", "batch") == "batch"

    def draw(shape):
        return torch.rand(shape, generator=gen, device=device)

    losses, first, trunk_first = [], {}, None
    for t, b in enumerate(batches, start=1):
        frames = torch.from_numpy(b["image_u8"]).to(device)
        B, H, W_, _ = frames.shape
        d = augment.sample(B, H, W_, gen, device)
        x = augment.apply(frames, d, s["image_px"], quant)
        live = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        leaves = {**w, **live}
        fi, pooled = image_features(cfg, leaves, x, batch_stats, quant)
        ids = torch.from_numpy(b["text"].astype(np.int64)).to(device)
        lens = torch.from_numpy(b["text_len"].astype(np.int64)).to(device)
        ft = _normalise(text.encode(leaves, ids, lens, TEXT_PREFIX, draw))
        logits = fi @ ft.T * scale
        if half_batch:
            logits = logits[:B // 2, :B // 2]
        loss = infonce.loss(logits)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(params[n]) if g is None else g)
                 for n, g in zip(live, grads)}
        if t == 1:
            first = {n: g.clone() for n, g in grads.items()}
            trunk_first = pooled
        adamw.step(params, grads, state, t, opt["lr"], opt["weight_decay"],
                   tuple(opt["betas"]), opt["eps"])
        losses.append(float(loss.detach()))
    return losses, first, params, trunk_first
