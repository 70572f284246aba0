"""One AdamW step (Loshchilov and Hutter 2019), as optax's ``adamw`` and
torch's ``AdamW`` define it: the decay decoupled and applied first, then
the bias-corrected moment ratio."""

from __future__ import annotations

import math
from typing import Dict

import torch


def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: Dict[str, Dict[str, torch.Tensor]], t: int, lr: float,
         weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """Updates ``params`` and ``state`` (per leaf: m, v) in place; ``t`` is
    the step's number, from 1."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        s = state.setdefault(name, {"m": torch.zeros_like(p),
                                    "v": torch.zeros_like(p)})
        s["m"].mul_(b1).add_((1 - b1) * g)
        s["v"].mul_(b2).add_((1 - b2) * g * g)
        p.mul_(1 - lr * weight_decay)
        denom = (s["v"] / (1 - b2 ** t)).sqrt() + eps
        p.sub_(lr * (s["m"] / (1 - b1 ** t)) / denom)


def first_moment_to_grad(m: torch.Tensor, b1: float = 0.9) -> torch.Tensor:
    """The gradient of step 1 from the first moment after it: m = (1 - b1) g."""
    return m / (1 - b1)


def norm(x: torch.Tensor) -> float:
    return math.sqrt(float(x.double().pow(2).sum()))
