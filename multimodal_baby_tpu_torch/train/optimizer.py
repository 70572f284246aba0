"""Optimizer construction (counterpart of
``multimodal_baby_tpu/train/optimizer.py``): AdamW, Adam or SGD over the
trainable parameters, with the vision trunk frozen unless ``finetune_cnn``,
and the plateau LR schedule.

``TrainConfig.optimizer`` may give AdamW options after a colon (the port
only; ``parse_optimizer``): ``"AdamW:beta2=0.98,eps=1e-6,decay=matrices"``
is CLIP's AdamW (Radford et al. 2021; OpenCLIP): beta2 and eps as given, and
the weight decay only on the leaves of two or more axes (OpenCLIP leaves
gains, biases, the class embedding and the logit scale undecayed). The
bare names keep the JAX package's settings."""

from __future__ import annotations

from typing import Dict, Tuple

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
    "AdamW": lambda params, lr, o: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, o["beta2"]), eps=o["eps"]),
    "Adam": lambda params, lr, o: torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
    "SGD": lambda params, lr, o: torch.optim.SGD(params, lr=lr),
}
# AdamW's options and their values without them (optax's); ``decay``:
# every trainable leaf ("all") or those of two or more axes ("matrices")
_ADAMW_OPTIONS = {"beta2": 0.999, "eps": 1e-8, "decay": "all"}
_DECAY_RULES = ("all", "matrices")


def parse_optimizer(spec: str) -> Tuple[str, Dict[str, object]]:
    """``"AdamW"`` or ``"AdamW:beta2=0.98,eps=1e-6,decay=matrices"`` ->
    (the name, every AdamW option with its default filled in). Unknown
    names, options and values raise ValueError; Adam and SGD take no
    options."""
    name, _, rest = spec.partition(":")
    if name not in _OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(_OPTIMIZERS)}, "
                         f"got {spec!r}")
    options = dict(_ADAMW_OPTIONS)
    for item in filter(None, rest.split(",")):
        key, _, value = item.partition("=")
        if name != "AdamW" or key not in options:
            raise ValueError(f"optimizer {spec!r}: unknown option {key!r}")
        if key == "decay":
            if value not in _DECAY_RULES:
                raise ValueError(f"optimizer {spec!r}: decay must be one of "
                                 f"{_DECAY_RULES}, got {value!r}")
            options[key] = value
        else:
            try:
                options[key] = float(value)
            except ValueError:
                raise ValueError(f"optimizer {spec!r}: {key} must be a "
                                 f"number, got {value!r}") from None
    return name, options


def build_optimizer(cfg: ExperimentConfig, model: nn.Module
                    ) -> torch.optim.Optimizer:
    """``cfg.train.optimizer`` (AdamW, Adam or SGD, as optax builds them,
    AdamW with ``parse_optimizer``'s options) over the trainable
    parameters, as the JAX package's masked optimizer. Frozen parameters
    get ``requires_grad=False`` and no optimizer state. The weight decay
    goes to every trainable leaf (one parameter group), or with
    ``decay=matrices`` to those of two or more axes (the first group; the
    second has none)."""
    t = cfg.train
    name, options = parse_optimizer(t.optimizer)
    mask = frozen_mask(model, cfg.model.vision.finetune_cnn)
    params = []
    for pname, p in model.named_parameters():
        p.requires_grad_(mask[pname])
        if mask[pname]:
            params.append(p)
    if options["decay"] == "all":
        groups = [{"params": params, "weight_decay": t.weight_decay}]
    else:
        groups = [{"params": [p for p in params if p.dim() >= 2],
                   "weight_decay": t.weight_decay},
                  {"params": [p for p in params if p.dim() < 2],
                   "weight_decay": 0.0}]
    return _OPTIMIZERS[name](groups, t.lr, options)


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
