"""On-device image augmentation and normalization (counterpart of
``multimodal_baby_tpu/data/augment.py``).

RandomResizedCrop(scale=(0.2, 1)) + GaussianBlur(sigma U(0.1, 2), p=0.5) +
RandomHorizontalFlip + ImageNet normalize, as two batched resampling
products per image: crop, resize, flip and blur are linear, so they compose
into a row matrix and a column matrix.

Two opt-in forms of the same products: ``s2d`` emits the space-to-depth
layout ``[B, out/2, out/2, 12]`` that the ResNeXt's 4x4 stem takes (the
split stem), by slicing the resampling matrices into their even and odd
output rows, so no transpose touches the image; ``csplit`` (the JAX
package's ``MMB_AUG_CSPLIT``) resamples one channel at a time.

The randomness is split from the arithmetic: ``sample_augment`` draws the
crop boxes, flips and blur from a ``torch.Generator``, and
``apply_augment`` takes those numbers. The tests hand the JAX package's
draws to ``apply_augment``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)

_BLUR_RADIUS = 6  # 13-tap band
_CROP_SCALE = (0.2, 1.0)      # area fraction, uniform
_CROP_RATIO = (3 / 4, 4 / 3)  # aspect ratio, log-uniform


class AugmentDraws(NamedTuple):
    boxes: torch.Tensor    # [B, 4] f32: y0, x0, h, w
    do_flip: torch.Tensor  # [B] bool
    do_blur: torch.Tensor  # [B] bool
    sigmas: torch.Tensor   # [B] f32


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 or float [..., H, W, 3] -> ImageNet-normalized float32."""
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _sample_crop_boxes(batch: int, hw: Tuple[int, int],
                       generator: torch.Generator | None, device=None
                       ) -> torch.Tensor:
    """[B, 4] boxes (y0, x0, h, w): area scale uniform, log-uniform aspect
    ratio, sides clipped to [8, side] instead of resampled."""
    H, W = hw
    u = torch.rand((4, batch), generator=generator, device=device)
    area = H * W * (_CROP_SCALE[0]
                    + (_CROP_SCALE[1] - _CROP_SCALE[0]) * u[0])
    lo, hi = math.log(_CROP_RATIO[0]), math.log(_CROP_RATIO[1])
    r = torch.exp(lo + (hi - lo) * u[1])
    w = torch.sqrt(area * r).clamp(8.0, float(W))
    h = torch.sqrt(area / r).clamp(8.0, float(H))
    y0 = u[2] * (H - h)
    x0 = u[3] * (W - w)
    return torch.stack([y0, x0, h, w], dim=1)


def sample_augment(batch: int, hw: Tuple[int, int],
                   generator: torch.Generator | None, device=None
                   ) -> AugmentDraws:
    """Draw one batch's augmentation parameters. ``generator`` lives on
    ``device`` (or is None for the default generator)."""
    boxes = _sample_crop_boxes(batch, hw, generator, device)
    u = torch.rand((3, batch), generator=generator, device=device)
    return AugmentDraws(boxes=boxes, do_flip=u[0] < 0.5, do_blur=u[1] < 0.5,
                        sigmas=0.1 + 1.9 * u[2])


def _interp_matrices(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """coords [B, out] (already clipped to [0, in_size - 1]) -> bilinear
    interpolation matrices [B, out, in_size]; each row sums to 1."""
    grid = torch.arange(in_size, dtype=torch.float32, device=coords.device)
    return (1.0 - (coords[:, :, None] - grid).abs()).clamp_min(0.0)


def _blur_matrices(do_blur: torch.Tensor, sigmas: torch.Tensor, size: int
                   ) -> torch.Tensor:
    """Per-image Gaussian band matrices [B, size, size] in bf16 (13 taps,
    each row normalised in f32 over the taps inside the image); identity
    where ``do_blur`` is False."""
    grid = torch.arange(size, dtype=torch.float32, device=sigmas.device)
    d = grid[None, :, None] - grid[None, None, :]
    g = torch.exp(-0.5 * (d / sigmas[:, None, None]) ** 2)
    g = torch.where(d.abs() > float(_BLUR_RADIUS), 0.0, g)
    g = g / g.sum(dim=-1, keepdim=True)
    eye = torch.eye(size, device=sigmas.device)[None]
    return torch.where(do_blur[:, None, None], g, eye).to(torch.bfloat16)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C] in (i, j, c) channel order: the
    layout the ResNeXt's 4x4 stem takes."""
    b, h, w, c = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(b, h // 2, w // 2, 4 * c)


def apply_augment(images: torch.Tensor, draws: AugmentDraws,
                  out_size: int = 224, dtype=torch.float32,
                  s2d: bool = False, csplit: bool = False) -> torch.Tensor:
    """[B, H, W, 3] uint8 (or float) -> [B, out, out, 3] in ``dtype``, or
    with ``s2d`` its space-to-depth layout [B, out/2, out/2, 12] (the row
    and column products on the even and odd output taps, concatenated in
    (i, j, c) order). ``csplit`` runs the two products one channel at a
    time (``s2d`` takes precedence, as in the JAX package).

    Coordinates and weights are computed in f32; the resampling matrices
    and pixels are bf16 and the products run in bf16, at the same places as
    the JAX package."""
    B, H, W, _ = images.shape
    y0, x0, h, w = draws.boxes.float().unbind(dim=1)
    o = torch.arange(out_size, dtype=torch.float32,
                     device=images.device) + 0.5
    ys = y0[:, None] + o[None, :] * (h / out_size)[:, None] - 0.5
    xs = x0[:, None] + o[None, :] * (w / out_size)[:, None] - 0.5
    # the horizontal flip is folded into the column coordinates
    xs = torch.where(draws.do_flip[:, None], xs.flip(1), xs)

    bf16 = torch.bfloat16
    ry = _interp_matrices(ys.clamp(0.0, H - 1.0), H).to(bf16)  # [B, out, H]
    cx = _interp_matrices(xs.clamp(0.0, W - 1.0), W).to(bf16)  # [B, out, W]
    gy = _blur_matrices(draws.do_blur, draws.sigmas, out_size)
    a_row = torch.bmm(gy, ry)                                  # [B, out, H]
    a_col = torch.bmm(gy, cx)                                  # [B, out, W]

    f = images.float()
    if images.dtype == torch.uint8:
        f = f / 255.0
    f = f.to(bf16)
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=images.device)
    if s2d:
        rows = [torch.einsum("bph,bhwc->bpwc", a_row[:, i::2], f)
                for i in range(2)]
        slots = [(torch.einsum("bsw,bpwc->bpsc", a_col[:, j::2], rows[i])
                  .to(dtype) - mean) / std
                 for i in range(2) for j in range(2)]
        return torch.cat(slots, dim=-1)
    if csplit:
        outs = []
        for ch in range(f.shape[-1]):
            t = torch.bmm(a_row, f[..., ch])                  # [B, out, W]
            o = torch.bmm(t, a_col.transpose(1, 2))           # [B, out, out]
            outs.append((o.to(dtype) - mean[ch]) / std[ch])
        return torch.stack(outs, dim=-1)
    x = torch.einsum("bph,bhwc->bpwc", a_row, f)
    x = torch.einsum("bsw,bpwc->bpsc", a_col, x)
    return (x.to(dtype) - mean) / std


def augment_batch(images: torch.Tensor, out_size: int = 224,
                  augment: bool = True, dtype=torch.float32,
                  generator: torch.Generator | None = None,
                  s2d: bool = False, csplit: bool = False) -> torch.Tensor:
    """Train-time pipeline on [B, H, W, 3] uint8 frames; ``augment=False``
    only normalizes (and resizes bilinearly, with antialiasing, when the
    frames are not ``out_size`` square). ``s2d`` and ``csplit`` as in
    ``apply_augment``; without the augment ``s2d`` rearranges the
    normalized frames with ``space_to_depth``."""
    B, H, W, _ = images.shape
    if not augment:
        if (H, W) == (out_size, out_size):
            x = normalize_image(images).to(dtype)
        else:
            x = images.float()
            if images.dtype == torch.uint8:
                x = x / 255.0
            x = F.interpolate(x.permute(0, 3, 1, 2),
                              size=(out_size, out_size), mode="bilinear",
                              align_corners=False,
                              antialias=True).permute(0, 2, 3, 1)
            x = normalize_image(x).to(dtype)
        return space_to_depth(x) if s2d else x
    draws = sample_augment(B, (H, W), generator, images.device)
    return apply_augment(images, draws, out_size, dtype, s2d, csplit)
