"""Activation-range calibration for the int8 trunk (counterpart of
``multimodal_baby_tpu/models/quant_calib.py``).

The int8 stages quantize every activation tensor with a per-tensor scale
amax / 127. Uncalibrated (amax 0), the trunk uses a bound from the folded
BatchNorm; ``calibrate_backbone`` measures the ranges on sample images with
the f32 conv path, and ``calibrate_cvcl`` writes them into the trunk's
amax buffers (``models/vision_resnext.py``), as the published recipe does
once before its first step (``bench.py:146-151``).
"""

from __future__ import annotations

from typing import Dict

import torch

from multimodal_baby_tpu_torch.models.vision_resnext import (
    RESNEXT50_STAGES, ResNeXt50)

Scales = Dict[str, object]


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.float().max().clamp_min(0.0)


@torch.no_grad()
def calibrate_backbone(trunk: ResNeXt50, images: torch.Tensor) -> Scales:
    """Measure the activation amaxes on the f32 conv path (BatchNorm on
    running statistics, no kernels).

    images: [B, H, W, 3] normalized. Returns the JAX package's
    "quant_scales" subtree: {"stem_amax": s, "layer1_0": {"h1_amax": ...,
    "h2_amax": ..., "out_amax": ...}, ...}, each max(max(t), 0) of the
    stem's BatchNorm output, a block's bn1 and bn2 outputs and the block's
    output."""
    seen: Dict[str, torch.Tensor] = {}

    def grab(name):
        def hook(module, inputs, output):
            seen[name] = _amax(output)
        return hook

    hooks = [trunk.bn1.register_forward_hook(grab("stem_amax"))]
    for stage_idx, (_, blocks, _) in enumerate(RESNEXT50_STAGES):
        for block_idx, block in enumerate(getattr(trunk,
                                                  f"layer{stage_idx + 1}")):
            name = f"layer{stage_idx + 1}_{block_idx}"
            hooks += [block.bn1.register_forward_hook(grab(f"{name}/h1_amax")),
                      block.bn2.register_forward_hook(grab(f"{name}/h2_amax")),
                      block.register_forward_hook(grab(f"{name}/out_amax"))]
    try:
        trunk.forward_conv(images.float())
    finally:
        for h in hooks:
            h.remove()
    scales: Scales = {"stem_amax": seen.pop("stem_amax")}
    for key, value in seen.items():
        block, name = key.split("/")
        scales.setdefault(block, {})[name] = value
    return scales


@torch.no_grad()
def load_quant_scales(trunk: ResNeXt50, scales: Scales) -> None:
    """Copy a "quant_scales" subtree into the trunk's amax buffers; entries
    for which the trunk's plan holds no buffer are skipped."""
    buffers = dict(trunk.named_buffers())
    flat = {"stem_amax": scales["stem_amax"]}
    for key, value in scales.items():
        if isinstance(value, dict):  # "layer3_0" -> "layer3.0.h1_amax", ...
            flat.update({f"{key.replace('_', '.')}.{name}": v
                         for name, v in value.items()})
    for path, v in flat.items():
        if path in buffers:
            buffers[path].copy_(torch.as_tensor(v))


def calibrate_cvcl(model, images: torch.Tensor) -> Scales:
    """Calibrate a CVCL model's ResNeXt trunk on ``images`` (normalized)
    and write the ranges into its amax buffers; returns the scales."""
    trunk = model.vision_encoder.model
    scales = calibrate_backbone(trunk, images)
    load_quant_scales(trunk, scales)
    return scales
