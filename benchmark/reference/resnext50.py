"""ResNeXt-50 32x4d (Xie et al. 2017; torchvision's ``resnext50_32x4d``
layout and names), NCHW float32: the 7x7 stem, BatchNorm, ReLU, the 3x3
max-pool, 3 + 4 + 6 + 3 bottlenecks of 32 groups of width 4 per 64
planes, and the global average pool. BatchNorm (eps 1e-5) runs on the
running statistics, or with ``batch_stats`` on the statistics of the
batch (biased variance): the frozen trunk of the CVCL recipe trains so.

``quant`` rounds both operands of every convolution (the control's fp8);
the identity is float32."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.quant import identity
from benchmark.reference.weights import Spec

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
GROUPS = 32
WIDTH_PER_GROUP = 4
EXPANSION = 4
BN_EPS = 1e-5
OUT_DIM = 2048
HEAD = "fc"   # the projection head's leaves: <prefix>fc.weight, .bias
# the gain of each block's last BatchNorm: small, as in trained ResNets
# and torchvision's zero_init_residual (Goyal et al. 2017), so that the
# random trunk is not chaotic on batch statistics (at gain 1 a bf16
# rounding of the operands alone moves its pooled features by ~10%)
RESIDUAL_GAIN = 0.2


def blocks() -> List[Tuple[str, int, int, int, int, bool]]:
    """(name, in channels, width, out channels, stride, downsample) of every
    bottleneck."""
    out, c_in = [], 64
    for s, (planes, n, stride) in enumerate(STAGES):
        width = planes * WIDTH_PER_GROUP // 64 * GROUPS
        c_out = planes * EXPANSION
        for i in range(n):
            st = stride if i == 0 else 1
            out.append((f"layer{s + 1}.{i}", c_in, width, c_out, st, i == 0))
            c_in = c_out
    return out


def _bn_spec(prefix: str, c: int, gain: float = 1.0) -> Spec:
    return [(f"{prefix}.weight", (c,), ("scale", gain)),
            (f"{prefix}.bias", (c,), ("shift",)),
            (f"{prefix}.running_mean", (c,), ("shift",)),
            (f"{prefix}.running_var", (c,), ("var",))]


def _conv_spec(name: str, c_out: int, c_in: int, k: int) -> Spec:
    # He init: N(0, 2 / fan_in)
    return [(name, (c_out, c_in, k, k), ("normal", math.sqrt(2.0 / (c_in * k * k))))]


def spec(prefix: str, px: int = 224) -> Spec:
    """The trunk's leaves under ``prefix`` (e.g. "vision_encoder.model.");
    a convolutional trunk's leaves do not depend on the frames' size
    ``px``."""
    p = prefix
    out = _conv_spec(f"{p}conv1.weight", 64, 3, 7) + _bn_spec(f"{p}bn1", 64)
    for name, c_in, width, c_out, _, down in blocks():
        q = f"{p}{name}."
        out += _conv_spec(f"{q}conv1.weight", width, c_in, 1)
        out += _bn_spec(f"{q}bn1", width)
        out += _conv_spec(f"{q}conv2.weight", width, width // GROUPS, 3)
        out += _bn_spec(f"{q}bn2", width)
        out += _conv_spec(f"{q}conv3.weight", c_out, width, 1)
        out += _bn_spec(f"{q}bn3", c_out, RESIDUAL_GAIN)
        if down:
            out += _conv_spec(f"{q}downsample.0.weight", c_out, c_in, 1)
            out += _bn_spec(f"{q}downsample.1", c_out)
    return out


def _bn(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
        batch_stats: bool) -> torch.Tensor:
    if batch_stats:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    mul = w[f"{prefix}.weight"] / torch.sqrt(var + BN_EPS)
    add = w[f"{prefix}.bias"] - mean * mul
    return x * mul[:, None, None] + add[:, None, None]


def forward(w: Dict[str, torch.Tensor], x_nhwc: torch.Tensor,
            batch_stats: bool, prefix: str = "",
            quant: Callable = identity) -> torch.Tensor:
    """x [B, H, W, 3] float32 (ImageNet-normalised) -> pooled [B, 2048]."""
    def conv(x, name, stride=1, padding=0, groups=1):
        return F.conv2d(quant(x), quant(w[f"{prefix}{name}"]),
                        stride=stride, padding=padding, groups=groups)

    x = x_nhwc.permute(0, 3, 1, 2).float().contiguous()
    y = torch.relu(_bn(conv(x, "conv1.weight", 2, 3), w, f"{prefix}bn1",
                       batch_stats))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    for name, _, _, _, stride, down in blocks():
        q = f"{prefix}{name}"
        h = torch.relu(_bn(conv(y, f"{name}.conv1.weight"), w, f"{q}.bn1",
                           batch_stats))
        h = conv(h, f"{name}.conv2.weight", stride, 1, GROUPS)
        h = torch.relu(_bn(h, w, f"{q}.bn2", batch_stats))
        h = _bn(conv(h, f"{name}.conv3.weight"), w, f"{q}.bn3", batch_stats)
        identity_ = y
        if down:
            identity_ = _bn(conv(y, f"{name}.downsample.0.weight", stride),
                            w, f"{q}.downsample.1", batch_stats)
        y = torch.relu(h + identity_)
    return y.mean(dim=(2, 3))
