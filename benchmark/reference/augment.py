"""The CVCL training augment (the reference's torchvision pipeline:
RandomResizedCrop(224, scale=(0.2, 1)), GaussianBlur(sigma U(0.1, 2),
p = 0.5), RandomHorizontalFlip, ImageNet normalisation), float32.

``sample`` is a frozen copy of the sampling rule the configuration's
augment follows: from a generator on the frames' device, a uniform
[4, B] draw for the crop (area scale uniform in [0.2, 1], log-uniform
aspect ratio in [3/4, 4/3], sides clipped to [8, side], the corner
uniform in what is left), then a uniform [3, B] draw for the flip
(< 0.5), the blur (< 0.5) and its sigma (0.1 + 1.9 u). ``apply`` resamples
bilinearly at pixel centres (coordinates clipped to the frame), blurs
with a 13-tap Gaussian whose rows are normalised over the taps inside the
frame, flips by reversing the column coordinates, and normalises."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from benchmark.reference.quant import identity

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BLUR_RADIUS = 6


class Draws(NamedTuple):
    boxes: torch.Tensor   # [B, 4]: y0, x0, h, w
    flip: torch.Tensor    # [B] bool
    blur: torch.Tensor    # [B] bool
    sigma: torch.Tensor   # [B]


def sample(batch: int, h_in: int, w_in: int, gen: torch.Generator,
           device) -> Draws:
    u = torch.rand((4, batch), generator=gen, device=device)
    area = h_in * w_in * (0.2 + 0.8 * u[0])
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    r = torch.exp(lo + (hi - lo) * u[1])
    w = torch.sqrt(area * r).clamp(8.0, float(w_in))
    h = torch.sqrt(area / r).clamp(8.0, float(h_in))
    boxes = torch.stack([u[2] * (h_in - h), u[3] * (w_in - w), h, w], dim=1)
    v = torch.rand((3, batch), generator=gen, device=device)
    return Draws(boxes, v[0] < 0.5, v[1] < 0.5, 0.1 + 1.9 * v[2])


def _bilinear(coords: torch.Tensor, size: int) -> torch.Tensor:
    grid = torch.arange(size, dtype=torch.float64, device=coords.device)
    c = coords.clamp(0.0, size - 1.0)
    return (1.0 - (c[:, :, None] - grid).abs()).clamp_min(0.0)


def _blur(blur: torch.Tensor, sigma: torch.Tensor, size: int) -> torch.Tensor:
    grid = torch.arange(size, dtype=torch.float64, device=sigma.device)
    d = grid[:, None] - grid[None, :]
    g = torch.exp(-0.5 * (d[None] / sigma[:, None, None]) ** 2)
    g = torch.where(d.abs()[None] > BLUR_RADIUS, 0.0, g)
    g = g / g.sum(dim=-1, keepdim=True)
    eye = torch.eye(size, dtype=torch.float64, device=sigma.device)[None]
    return torch.where(blur[:, None, None], g, eye)


def apply(frames_u8: torch.Tensor, d: Draws, out: int,
          quant: Callable = identity) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, out, out, 3] float32, normalised. The
    resampling matrices are built in float64 and applied in float32;
    ``quant`` rounds the matrices and the pixels (the control)."""
    B, H, W, _ = frames_u8.shape
    y0, x0, h, w = d.boxes.double().unbind(1)
    o = torch.arange(out, dtype=torch.float64, device=frames_u8.device) + 0.5
    ys = y0[:, None] + o[None] * (h / out)[:, None] - 0.5
    xs = x0[:, None] + o[None] * (w / out)[:, None] - 0.5
    xs = torch.where(d.flip[:, None], xs.flip(1), xs)
    g = _blur(d.blur, d.sigma.double(), out)
    rows = quant((g @ _bilinear(ys, H)).float())   # [B, out, H]
    cols = quant((g @ _bilinear(xs, W)).float())   # [B, out, W]
    f = quant(frames_u8.float() / 255.0)
    x = torch.einsum("bph,bhwc->bpwc", rows, f)
    x = torch.einsum("bsw,bpwc->bpsc", cols, quant(x))
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x - mean) / std


def normalise(frames_u8: torch.Tensor) -> torch.Tensor:
    """Frames without the augment: [B, H, W, 3] float32, normalised."""
    mean = torch.tensor(MEAN, device=frames_u8.device)
    std = torch.tensor(STD, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - mean) / std
