"""Grad-CAM attention maps for the dual encoder (counterpart of
``multimodal_baby_tpu/analysis/attention_maps.py``; reference: the
Hook-based implementation, multimodal/attention_maps.py:83-170).

The channel weights are the spatial means of the gradient of the
image-text similarity (or of a caption token's cross-entropy) with
respect to the trunk's last feature map; CAM = relu(sum_c alpha_c *
activation_c), upsampled bicubically to the input size and scaled to
[0, 1].

The trunk runs forward without autograd, on the card through its kernel
plan, as everywhere else; its feature map, in f32, becomes the leaf of the
gradient, and only the head runs under ``torch.autograd.grad``: the pool,
the vision projection, the l2 normalization and the similarity with the
text features (or the LM's cross-entropy for captioning). The gradient is
taken with respect to the feature map, not the image, so no backward of a
trunk kernel is needed: the JAX package's custom VJP of K1
(``fused_bottleneck_hwbc_diff``) has no port.

The upsampling is ``jax.image.resize(..., "bicubic")``'s: the Keys cubic
with a = -0.5 on half-pixel centres, each output's weights divided by
their sum at the edges (``bicubic_matrix``). torch's
``interpolate(mode="bicubic")`` uses a = -0.75, and its maps differ
visibly from the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimodal_baby_tpu_torch.models.losses import lm_cross_entropy
from multimodal_baby_tpu_torch.models.multimodal import CVCL, l2_normalize

_EPS_F32 = float(np.finfo(np.float32).eps)


def bicubic_matrix(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights of ``jax.image.resize``'s bicubic
    resampling along one axis (antialiased: the kernel widens by the
    scale when downsampling); out = x @ W along that axis."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    inv = torch.tensor(inv_scale, dtype=torch.float32)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[
        :, None]).abs() / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, 0.0, w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS_F32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_bicubic(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """[..., h, w] -> [..., out_size, out_size], as ``jax.image.resize``
    with method "bicubic"."""
    h, w = x.shape[-2:]
    wh = bicubic_matrix(h, out_size, x.device)
    ww = bicubic_matrix(w, out_size, x.device)
    return torch.einsum("...hw,hi,wj->...ij", x.float(), wh, ww)


def _head_features(model: CVCL, fm: torch.Tensor) -> torch.Tensor:
    """The head on a feature map [B, h, w, C]: pool, project, normalize."""
    feats = model.vision_encoder.model.fc(fm.mean(dim=(1, 2)))
    if model.cfg.normalize_features:
        feats = l2_normalize(feats, dim=1)
    return feats


def _feature_map(model: CVCL, images: torch.Tensor) -> torch.Tensor:
    """The trunk's feature map in f32, detached: the gradient's leaf."""
    if model.cfg.vision.vit_dino:
        raise ValueError("grad-CAM needs a CNN backbone with a spatial "
                         "feature map")
    with torch.no_grad():
        _, feature_map = model.encode_image(images)
    return feature_map.detach().float().requires_grad_(True)


def _cam(alpha: torch.Tensor, fm: torch.Tensor) -> torch.Tensor:
    """relu(sum_c alpha_c * fm_c) [B, h, w] from alpha [B, C]."""
    return torch.relu((alpha[:, None, None, :] * fm.detach()).sum(-1))


def grad_cam(
    model: CVCL,
    images: torch.Tensor,    # [B, H, W, 3] normalized float
    text: torch.Tensor,      # [B, L] (one utterance per image)
    text_len: torch.Tensor,  # [B]
    out_size: Optional[int] = None,
) -> np.ndarray:
    """Returns saliency maps [B, out_size, out_size] in [0, 1]."""
    out_size = out_size or images.shape[1]
    with torch.no_grad():
        text_features, _ = model.encode_text(text, text_len)
    fm = _feature_map(model, images)
    with torch.enable_grad():
        sim = (_head_features(model, fm) * text_features).sum()
        grads, = torch.autograd.grad(sim, fm)
    cam = _cam(grads.mean(dim=(1, 2)), fm)
    cam = resize_bicubic(cam, out_size).clamp_min(0.0)
    cam_max = cam.flatten(1).amax(dim=1)[:, None, None]
    cam = torch.where(cam_max > 0, cam / cam_max.clamp_min(1e-12), cam)
    return cam.cpu().numpy()


def grad_cam_captioning(
    model: CVCL,
    image: torch.Tensor,     # [H, W, 3] normalized float (one image)
    text,                    # [L] token ids
    text_len: int,
    out_size: Optional[int] = None,
    steps=None,
) -> np.ndarray:
    """Per-token-step grad-CAM for a captioning LM
    (analysis_tools/multimodal_visualization.py:10-62): for each step t,
    the CAM of the token-t cross-entropy with respect to the feature map,
    with the gradient's sign flipped as in the reference. Returns
    [n_steps, out, out]; step 0 has no preceding prediction and gets a
    zero map, like the reference's None. One forward of the head and the
    LM serves every step."""
    out_size = out_size or image.shape[0]
    steps = list(range(int(text_len))) if steps is None else list(steps)
    device = image.device
    text_b = torch.as_tensor(text, device=device).long()[None]
    len_b = torch.tensor([int(text_len)], device=device)
    fm = _feature_map(model, image[None])
    with torch.enable_grad():
        feats = _head_features(model, fm)
        _, logits, _ = model.lm_forward(text_b, len_b, image_features=feats)
        labels, logits = model.lm_labels_and_logits(text_b, logits)
        ce, _ = lm_cross_entropy(logits, labels)
        maps = []
        for step in steps:
            if step == 0:
                maps.append(torch.zeros((out_size, out_size), device=device))
                continue
            g, = torch.autograd.grad(ce[0, step - 1], fm, retain_graph=True)
            cam = _cam((-g).mean(dim=(1, 2)), fm)[0]
            cam = resize_bicubic(cam, out_size).clamp_min(0.0)
            m = cam.max()
            maps.append(torch.where(m > 0, cam / m, cam))
    return torch.stack(maps).cpu().numpy()


def get_attention_overlay(image_01: np.ndarray, attn_map: np.ndarray,
                          blur_sigma: float = 0.02) -> np.ndarray:
    """Blend a [H, W, 3] image in [0,1] with a [H, W] attention map —
    the reference's getAttMap visualization (attention_maps.py:35-80),
    matplotlib-free (a copy of the JAX package's numpy function)."""
    a = attn_map.astype(np.float32)
    if blur_sigma > 0:
        # separable gaussian blur in numpy
        radius = max(1, int(3 * blur_sigma * image_01.shape[0]))
        x = np.arange(-radius, radius + 1, dtype=np.float32)
        k = np.exp(-0.5 * (x / (blur_sigma * image_01.shape[0])) ** 2)
        k /= k.sum()
        a = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 0, a)
        a = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, a)
        rng = a.max() - a.min()
        if rng > 0:
            a = (a - a.min()) / rng
    # simple red-heat overlay
    heat = np.stack([a, np.zeros_like(a), 1.0 - a], axis=-1)
    return (1 - a[..., None]) * image_01 + a[..., None] * heat
