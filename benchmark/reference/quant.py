"""The control's precision: products with both operands rounded to
float8 e4m3 (one scale per tensor, amax / 448), accumulated in float32,
as an fp8 path would compute them. It is the step below the bf16 that
the configurations state for the augment and the trunk."""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, returned in f32."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
