"""Optimizer construction (counterpart of
``multimodal_baby_tpu/train/optimizer.py``): AdamW over the trainable
parameters, with the vision trunk frozen unless ``finetune_cnn``."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from multimodal_baby_tpu_torch.core.config import ExperimentConfig

_TRUNK = "vision_encoder.model."
# the projection heads: ``fc`` on the ResNeXt, ``head`` on the ViT
_HEADS = ("vision_encoder.model.fc.", "vision_encoder.model.head.")


def frozen_mask(model: nn.Module, finetune_cnn: bool) -> Dict[str, bool]:
    """{parameter name: trainable}. The vision trunk (either backbone) is
    frozen unless ``finetune_cnn``; its projection head stays trainable."""
    return {name: finetune_cnn or not name.startswith(_TRUNK)
            or name.startswith(_HEADS)
            for name, _ in model.named_parameters()}


def build_optimizer(cfg: ExperimentConfig, model: nn.Module
                    ) -> torch.optim.Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) over the
    trainable parameters, as optax.adamw under the JAX package's mask.
    Frozen parameters get ``requires_grad=False`` and no optimizer state."""
    t = cfg.train
    if t.optimizer != "AdamW":
        raise NotImplementedError(
            f"the port's optimizer is AdamW; got {t.optimizer!r}")
    mask = frozen_mask(model, cfg.model.vision.finetune_cnn)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.AdamW(params, lr=t.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=t.weight_decay)
