"""ResNeXt-50 (32x4d) trunk (counterpart of
``multimodal_baby_tpu/models/vision_resnext.py``).

Parameters carry torchvision's ``resnext50_32x4d`` names (``conv1``,
``bn1``, ``layer{1..4}.{i}.{conv1,bn1,conv2,bn2,conv3,bn3,downsample.0,
downsample.1}``), so a reference state dict loads as it is. Images come in
and feature maps go out NHWC, as in the JAX package; the conv path runs on
NCHW views of channels-last data.

Two paths compute the same function:

- the conv path (``forward_conv``): plain convolutions with BatchNorm on
  running statistics, or on batch statistics when ``train`` is set (the
  reference's frozen-CNN quirk, ``frozen_bn="batch"``);
- the folded path (``forward_folded``): running BatchNorm folded into the
  weights once per weight state, then the 16 bottleneck blocks chained
  through ``ops.bottleneck.fused_bottleneck`` (the hand-written kernel on
  CUDA, its plain version on the CPU). It is the JAX package's fused trunk
  in the all-``blocks`` plan.

``forward`` takes the folded path exactly when the trunk is frozen, BN runs
on running statistics, the compute dtype is bf16 and the input is on CUDA.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.ops.bottleneck import (
    BN_EPS, GROUPS, fold_block_params, fused_bottleneck)

# stage definition for resnext50_32x4d: (planes, num_blocks, stride)
RESNEXT50_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2),
)
EXPANSION = 4
BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch


class InferenceBN(nn.Module):
    """BatchNorm over the channel dim of NCHW tensors, with torch's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``).

    Running statistics: one per-channel madd whose ``mul``/``add`` are
    computed in f32 and applied in the input dtype (the JAX package's
    ``InferenceBN``). Batch statistics: computed in f32 with
    E[x^2] - E[x]^2, the output rounded to the input dtype, and the running
    buffers updated in place with momentum 0.9 and the biased batch
    variance, as flax's ``nn.BatchNorm`` does (torch's own BatchNorm would
    update with the unbiased variance)."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mul, add) f32 vectors: y = x * mul + add."""
        mul = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return mul, self.bias - self.running_mean * mul

    def forward(self, x: torch.Tensor, batch_stats: bool = False
                ) -> torch.Tensor:
        if not batch_stats:
            mul, add = self.fold()
            return (x * mul.to(x.dtype)[:, None, None]
                    + add.to(x.dtype)[:, None, None])
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                (1 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.to(xf.dtype)[:, None, None]).to(x.dtype)


def _conv_weight(out_ch: int, in_ch: int, k: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))


class _Conv(nn.Module):
    """Weight holder with ``nn.Conv2d``'s state-dict name; the conv runs
    in the input's dtype (parameters stay f32, as in the JAX package).
    The weight follows a channels-last input into channels-last, so the
    convolution runs NHWC with no layout conversion."""

    def __init__(self, out_ch, in_ch, k, *, device=None):
        super().__init__()
        self.weight = _conv_weight(out_ch, in_ch, k, device)

    def forward(self, x, stride=1, padding=0, groups=1):
        w = self.weight.to(x.dtype)
        if x.is_contiguous(memory_format=torch.channels_last):
            w = w.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


class BottleneckX(nn.Module):
    """torchvision Bottleneck with groups=32, base_width=4 (conv path)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, device=None):
        super().__init__()
        width = planes * 4 // 64 * GROUPS
        out_ch = planes * EXPANSION
        self.stride = stride
        self.conv1 = _Conv(width, in_ch, 1, device=device)
        self.bn1 = InferenceBN(width, device=device)
        self.conv2 = _Conv(width, width // GROUPS, 3, device=device)
        self.bn2 = InferenceBN(width, device=device)
        self.conv3 = _Conv(out_ch, width, 1, device=device)
        self.bn3 = InferenceBN(out_ch, device=device)
        self.downsample = (
            nn.ModuleList([_Conv(out_ch, in_ch, 1, device=device),
                           InferenceBN(out_ch, device=device)])
            if has_downsample else None)

    def forward(self, x: torch.Tensor, batch_stats: bool = False
                ) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), batch_stats))
        y = self.conv2(y, stride=self.stride, padding=1, groups=GROUPS)
        y = torch.relu(self.bn2(y, batch_stats))
        y = self.bn3(self.conv3(y), batch_stats)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x, stride=self.stride), batch_stats)
        return torch.relu(y + identity)


def _nchw_view(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> an NCHW view of contiguous NHWC data, so that
    the convolutions, BN and pooling run channels-last."""
    return x.contiguous().permute(0, 3, 1, 2)


class ResNeXt50(nn.Module):
    """Trunk only. ``forward(x)`` with x ``[B, H, W, 3]`` returns
    ``{"pooled": [B, 2048] f32, "feature_map": [B, H/32, W/32, 2048]}`` in
    the compute dtype (the pool is taken in f32).

    ``dtype``: compute dtype (None = f32); parameters stay f32.
    ``frozen``: the trunk is not trained (the folded path may run).
    ``generator``: a CPU generator for the seeded init (``reset_parameters``).
    """

    def __init__(self, dtype: torch.dtype | None = None, frozen: bool = True,
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.frozen = frozen
        self.conv1 = _Conv(64, 3, 7, device=device)
        self.bn1 = InferenceBN(64, device=device)
        in_ch = 64
        for stage_idx, (planes, blocks, stride) in enumerate(RESNEXT50_STAGES):
            layer = []
            for block_idx in range(blocks):
                s = stride if block_idx == 0 else 1
                needs_ds = block_idx == 0 and (
                    s != 1 or in_ch != planes * EXPANSION)
                layer.append(BottleneckX(in_ch, planes, s, needs_ds,
                                         device=device))
                in_ch = planes * EXPANSION
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*layer))
        self._fold_key: tuple | None = None
        self._folded: List[Tuple[Dict[str, torch.Tensor], int]] = []
        self.reset_parameters(generator)

    def blocks(self) -> List[BottleneckX]:
        return [b for i in range(len(RESNEXT50_STAGES))
                for b in getattr(self, f"layer{i + 1}")]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init: convolutions N(0, 2/fan_in) (He), BN at identity."""
        for m in self.modules():
            if isinstance(m, _Conv):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(2.0 / fan_in))
            elif isinstance(m, InferenceBN):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def stem(self, x: torch.Tensor, batch_stats: bool = False
             ) -> torch.Tensor:
        """NCHW x -> conv 7x7/2 + BN + ReLU + maxpool 3/2 (pad 1), NCHW."""
        y = torch.relu(self.bn1(self.conv1(x, stride=2, padding=3),
                                batch_stats))
        return F.max_pool2d(y, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        if (self.frozen and not train and self.dtype == torch.bfloat16
                and x.is_cuda):
            return self.forward_folded(x)
        return self.forward_conv(x, train)

    def forward_conv(self, x: torch.Tensor, train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """The conv path in x's dtype; ``train`` = BN on batch statistics."""
        y = self.stem(_nchw_view(x), train)
        for block in self.blocks():
            y = block(y, train)
        return self._outputs(y.permute(0, 2, 3, 1))

    def forward_folded(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The folded path in x's dtype: BN on running statistics."""
        with torch.no_grad():
            y = self.stem(_nchw_view(x))
            y = y.permute(0, 2, 3, 1).contiguous()  # no copy: channels-last
            for fw, stride in self.folded(x.dtype):
                y = fused_bottleneck(y, fw, stride)
        return self._outputs(y)

    @staticmethod
    def _outputs(fmap: torch.Tensor) -> Dict[str, torch.Tensor]:
        # pool in f32; the map stays in the compute dtype
        return {"pooled": fmap.float().mean(dim=(1, 2)),
                "feature_map": fmap}

    def folded(self, dtype: torch.dtype
               ) -> List[Tuple[Dict[str, torch.Tensor], int]]:
        """Every block's folded weights, computed once per weight state:
        the cache key holds each block tensor's storage and version
        counter, so an in-place update (a loaded state dict, BN statistics
        updated in batch mode) refolds, and frozen weights fold once."""
        tensors = [t for b in self.blocks()
                   for t in (*b.parameters(), *b.buffers())]
        key = (dtype, *((t.data_ptr(), t._version) for t in tensors))
        if key != self._fold_key:
            with torch.no_grad():
                self._folded = [
                    (fold_block_params(b.state_dict(), dtype), b.stride)
                    for b in self.blocks()]
            self._fold_key = key
        return self._folded
