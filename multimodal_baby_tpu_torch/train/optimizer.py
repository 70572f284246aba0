"""Optimizer construction (counterpart of
``multimodal_baby_tpu/train/optimizer.py``): AdamW, Adam or SGD over the
trainable parameters, with the vision trunk frozen unless ``finetune_cnn``,
and the plateau LR schedule."""

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


# optax's builds (multimodal_baby_tpu/train/optimizer.py:38-45): AdamW's
# decay is decoupled; Adam's and SGD's (``add_decayed_weights`` first) is
# added to the gradient, which is torch's ``weight_decay`` for both
_OPTIMIZERS = {
    "AdamW": lambda params, lr, wd: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd),
    "Adam": lambda params, lr, wd: torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd),
    "SGD": lambda params, lr, wd: torch.optim.SGD(
        params, lr=lr, weight_decay=wd),
}


def build_optimizer(cfg: ExperimentConfig, model: nn.Module
                    ) -> torch.optim.Optimizer:
    """``cfg.train.optimizer`` (AdamW, Adam or SGD, as optax builds them)
    over the trainable parameters, as the JAX package's masked optimizer.
    Frozen parameters get ``requires_grad=False`` and no optimizer state."""
    t = cfg.train
    if t.optimizer not in _OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(_OPTIMIZERS)}, "
                         f"got {t.optimizer!r}")
    mask = frozen_mask(model, cfg.model.vision.finetune_cnn)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return _OPTIMIZERS[t.optimizer](params, t.lr, t.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the LR of every param group (optax's injected hyperparameter)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class ReduceLROnPlateau:
    """Host-side plateau tracker with torch semantics (factor, patience,
    mode=min on val_loss; multimodal_lit.py:117-121), the JAX package's
    class as it is."""

    def __init__(self, factor: float = 0.1, patience: int = 20,
                 min_lr: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float, lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        if metric < self.best:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
