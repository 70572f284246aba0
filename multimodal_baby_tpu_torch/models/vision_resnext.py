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
  reference's frozen-CNN quirk, ``frozen_bn="batch"``); on CUDA in bf16,
  where no gradient is needed, each batch-statistics BatchNorm with its
  ReLU and residual runs as the kernel pair K12 (``ops.batch_norm``);
- the folded path (``forward_folded``): running BatchNorm folded into the
  weights once per weight state, then the 16 bottleneck blocks run stage
  by stage as the plan says (the JAX package's fused trunk):
  - ``trunk_int8`` picks the stages that run in int8 (a contiguous suffix;
    the published recipe's ``(False, False, True, True)``), each "q" (int8
    products) or "t" (int8 transport: int8 codes between the blocks, bf16
    products inside): their blocks are folded (``ops/quant.py``) with
    activation ranges from the amax buffers (``models/quant_calib.py``;
    0 = uncalibrated, then the BatchNorm bound), and the chain quantizes
    once at the bf16 -> int8 boundary (a "t" -> "q" boundary passes the
    codes as they are) and dequantizes the pool and the feature map;
  - ``fused_plan`` picks each stage's kernels: ``"blocks"`` (one
    ``ops.bottleneck.fused_bottleneck`` per block: K1, or K2 in int8),
    ``"full"`` (the stage in one ``ops.stage.fused_stage``: K3a),
    ``"split"`` (the head block alone, then the tail as K3a),
    ``"bandedN"`` (the stage as ``ops.stage.fused_stage_banded`` over N
    output rows: K3b) and ``"splitbandN"`` (the head, then the tail as K3b);
    a "t" stage runs the same kernels in their transport mode (K10a).
  The kernels run on CUDA, their plain versions on the CPU.

``forward`` takes the folded path exactly when the trunk is frozen, BN runs
on running statistics, the compute dtype is bf16 and the input is on CUDA;
``fused_trunk`` (the JAX package's ``MMB_FUSED_TRUNK``) forces it on or
off.

The stem (both paths) is the 7x7 stride-2 convolution, or with ``stem=
"s2d"`` (``MMB_S2D_STEM``, bf16 and even H and W only) the same sums as a
4x4 stride-1 convolution over the space-to-depth input's 12 channels; an
input that already has 12 channels (``data/augment.py::augment_batch(s2d=
True)``, the split stem) always takes the 4x4 form. ``stem_cpad``
(``MMB_STEM_CPAD``) zero-pads the input channels, 3 -> 8 or 12 -> 16, which
changes no sum. The parameter stays the ``[64, 3, 7, 7]`` ``conv1.weight``.

No setting is read from the environment: the plans and modes are
constructor arguments, checked when the trunk is built.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.data.augment import space_to_depth
from multimodal_baby_tpu_torch.ops.batch_norm import (
    batch_moments, batch_norm_apply, batch_norm_stats, update_running)
from multimodal_baby_tpu_torch.ops.bottleneck import (
    BN_EPS, GROUPS, fold_block_params, fused_bottleneck)
from multimodal_baby_tpu_torch.ops.conv_epilogue import (
    conv1x1_bn_residual_relu)
from multimodal_baby_tpu_torch.ops.quant import (
    activation_scale, bn_amax_bound, fold_block_params_q,
    fold_block_params_t, quantize_activation, resolve_amax)
from multimodal_baby_tpu_torch.ops.stage import (
    fused_stage, fused_stage_banded)

# stage definition for resnext50_32x4d: (planes, num_blocks, stride)
RESNEXT50_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2),
)
EXPANSION = 4
# the JAX package's default kernel plan (multimodal_baby_tpu/models/
# vision_resnext.py:617): layer 1 in bands of 28 rows, layer 2 block by
# block, layer 3 as its head block then the tail, layer 4 whole
DEFAULT_PLAN = ("banded28", "blocks", "split", "full")
_PLAN_ENTRY = re.compile(r"(blocks|full|split|banded(\d*)|splitband(\d*))")
INT8_BATCH = 32  # int8 plans run in bf16 unless the batch is a multiple
STEMS = ("conv7", "s2d")


def check_stem(stem: Any) -> None:
    """``stem`` is "conv7" or "s2d"."""
    if stem not in STEMS:
        raise ValueError(f"stem must be one of {STEMS}, got {stem!r}")


def parse_int8_plan(raw: Any) -> Tuple[Any, ...]:
    """Per-stage int8 plan from ``VisionConfig.trunk_int8``: a bool (every
    stage), a 4-tuple of bools or entries, or a string "0,0,1,1" or
    "t,t,1,1" (one entry: every stage). Entries are False (bf16), "q"
    (int8) or "t" (int8 transport): True, "1", "q" and "true" mean "q";
    False, "0", "false" and "" mean bf16. The int8 stages, "t" and "q"
    alike, must form a contiguous suffix (the chain switches to int8
    codes once)."""
    n = len(RESNEXT50_STAGES)

    def tok(p):
        if isinstance(p, str):
            p = p.strip()
            if p in ("t", "q"):
                return p
            if p in ("1", "true", "True"):
                return "q"
            if p in ("0", "false", "False", ""):
                return False
            raise ValueError(f"int8-plan entry must be 0/1/t/q, got {p!r}")
        return "q" if p else False

    if isinstance(raw, str):
        parts = raw.split(",") if "," in raw else [raw] * n
    elif isinstance(raw, (tuple, list)):
        parts = list(raw)
    else:
        parts = [raw] * n
    if len(parts) != n:
        raise ValueError(f"trunk_int8 plan needs {n} entries, got {raw!r}")
    plan = tuple(tok(p) for p in parts)
    for a, b in zip(plan, plan[1:]):
        if a and not b:
            raise ValueError(
                "int8 stages must form a contiguous suffix of the trunk (got "
                f"plan {plan}); an int8 -> bf16 boundary is not supported")
    return plan


def parse_fused_plan(plan: Any) -> Tuple[str, ...]:
    """One kernel mode per stage: "blocks", "full", "split", "bandedN" or
    "splitbandN" (N rows per band; 14 when N is left out)."""
    plan = tuple(plan)
    if len(plan) != len(RESNEXT50_STAGES):
        raise ValueError(f"fused_plan needs {len(RESNEXT50_STAGES)} entries, "
                         f"got {plan!r}")
    for mode in plan:
        m = _PLAN_ENTRY.fullmatch(str(mode))
        rows = m and (m.group(2) or m.group(3))
        if m is None or (rows and int(rows) < 1):
            raise ValueError(f"unknown fused-plan entry {mode!r}")
    return plan


def _band_rows(mode: str, prefix: str) -> int:
    return int(mode[len(prefix):] or 14)


class InferenceBN(nn.Module):
    """BatchNorm over the channel dim of NCHW tensors, with torch's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``).

    Running statistics: one per-channel madd whose ``mul``/``add`` are
    computed in f32 and applied in the input dtype (the JAX package's
    ``InferenceBN``). Batch statistics: computed in f32 with
    E[x^2] - E[x]^2, the output rounded to the input dtype, and the running
    buffers updated in place with momentum 0.9 and the biased batch
    variance, as flax's ``nn.BatchNorm`` does (torch's own BatchNorm would
    update with the unbiased variance).

    ``forward_relu`` adds the ReLU and a block's residual; on batch
    statistics it runs K12 (``ops/batch_norm.py``) where ``takes_k12``
    holds, and this module's plain body elsewhere."""

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
        mean, var = batch_moments(xf, (0, 2, 3))
        update_running(self.running_mean, self.running_var, mean, var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.to(xf.dtype)[:, None, None]).to(x.dtype)

    def forward_relu(self, x: torch.Tensor, batch_stats: bool = False,
                     residual: torch.Tensor | None = None,
                     downsample: "InferenceBN | None" = None
                     ) -> torch.Tensor:
        """relu(self(x) + r) in x's dtype: r = downsample(residual) where a
        downsample BatchNorm is given, else residual (or nothing). Where
        ``takes_k12`` holds, one K12 statistics launch per BatchNorm and
        one apply launch for the whole (the downsample's normalised tensor
        is never written); elsewhere the plain modules, as before K12."""
        bns = (self,) if downsample is None else (self, downsample)
        tensors = (x,) if residual is None else (x, residual)
        if takes_k12(batch_stats, tensors, bns):
            rows = _rows(x)
            res = fold_r = None
            if residual is not None:
                res = _rows(residual)
                if downsample is not None:
                    fold_r = downsample._batch_fold(res)
            out = batch_norm_apply(rows, self._batch_fold(rows), res, fold_r)
            B, C, H, W = x.shape
            return out.view(B, H, W, C).permute(0, 3, 1, 2)
        y = self(x, batch_stats)
        if downsample is not None:
            residual = downsample(residual, batch_stats)
        return torch.relu(y if residual is None else y + residual)

    def _batch_fold(self, rows: torch.Tensor) -> torch.Tensor:
        """K12's statistics pass over rows [pixels, C]: the fold [mul, add]
        [2, C], running buffers updated."""
        return batch_norm_stats(rows, self.weight, self.bias,
                                self.running_mean, self.running_var)


def takes_k12(batch_stats: bool, tensors, bns) -> bool:
    """Whether BatchNorm goes through K12: batch statistics, every tensor
    an NCHW view of channels-last bf16 data on CUDA with C % 8 == 0, and
    no gradient needed (the frozen trunk in training; fine-tuning takes
    the plain path, whose autograd gives BN's gradient)."""
    if not batch_stats:
        return False
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.bfloat16 and t.dim() == 4
                and t.shape[1] % 8 == 0
                and t.is_contiguous(memory_format=torch.channels_last)):
            return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tensors, *(p for bn in bns
                                              for p in (bn.weight, bn.bias)))))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """NCHW view of channels-last data -> [pixels, C], a view."""
    B, C, H, W = t.shape
    return t.permute(0, 2, 3, 1).view(B * H * W, C)


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
        return F.conv2d(x, _like(self.weight.to(x.dtype), x), stride=stride,
                        padding=padding, groups=groups)


class BottleneckX(nn.Module):
    """torchvision Bottleneck with groups=32, base_width=4 (conv path).

    ``fused_epilogue`` (the JAX package's flag of the same name): conv3,
    bn3, the residual add and ReLU as one kernel call
    (``ops.conv_epilogue.conv1x1_bn_residual_relu``, K11) where the block
    runs on CUDA in bf16 with BatchNorm on running statistics; elsewhere
    the plain convolutions. ``ResNeXt50`` leaves it off, as the JAX
    package does."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, device=None,
                 fused_epilogue: bool = False):
        super().__init__()
        width = planes * 4 // 64 * GROUPS
        out_ch = planes * EXPANSION
        self.stride = stride
        self.fused_epilogue = fused_epilogue
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
        y = self.bn1.forward_relu(self.conv1(x), batch_stats)
        y = self.conv2(y, stride=self.stride, padding=1, groups=GROUPS)
        y = self.bn2.forward_relu(y, batch_stats)
        identity, ds_bn = x, None
        if self.downsample is not None:
            conv, ds_bn = self.downsample
            identity = conv(x, stride=self.stride)
        if self.use_epilogue(y, batch_stats):
            if ds_bn is not None:
                identity = ds_bn(identity)
            return self._conv3_epilogue(y, identity)
        return self.bn3.forward_relu(self.conv3(y), batch_stats, identity,
                                     ds_bn)

    def use_epilogue(self, y: torch.Tensor, batch_stats: bool) -> bool:
        """Whether conv3 and what follows go through K11 (the JAX package's
        condition, with CUDA in place of the TPU)."""
        return (self.fused_epilogue and not batch_stats
                and y.dtype == torch.bfloat16 and y.is_cuda)

    def _conv3_epilogue(self, y: torch.Tensor, identity: torch.Tensor
                        ) -> torch.Tensor:
        """relu(bn3(conv3(y)) + identity) through K11, on NCHW views of
        channels-last data: the pixels are the GEMM's rows."""
        B, _, Ho, Wo = y.shape

        def rows(t):  # NCHW view -> [pixels, C], a view when channels-last
            return t.permute(0, 2, 3, 1).reshape(B * Ho * Wo, -1).contiguous()

        w3 = self.conv3.weight[:, :, 0, 0].t().to(y.dtype).contiguous()
        mul, add = self.bn3.fold()
        out = conv1x1_bn_residual_relu(rows(y), w3, mul.float().contiguous(),
                                       add.float().contiguous(),
                                       rows(identity))
        return out.reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2)


def _like(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The weight in x's memory format (channels-last x: channels-last w,
    so the convolution runs NHWC with no layout conversion)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return w.contiguous(memory_format=torch.channels_last)
    return w


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
    ``trunk_int8``: the int8 stages (``parse_int8_plan``); with any, the
    trunk holds the activation-range buffers ``stem_amax`` and, per block,
    ``out_amax`` and ("q" blocks) ``h1_amax`` and ``h2_amax``, where the
    JAX package declares its "quant_scales" variables; 0 = uncalibrated.
    ``fused_plan``: the kernel mode of each stage (``parse_fused_plan``).
    ``fused_trunk``: None (the folded path on CUDA where it applies), True
    (wherever it applies; a call where it does not raises) or False (the
    conv path always). ``stem``: "conv7" or "s2d"; ``stem_cpad``: the
    stem's input channels zero-padded (the module's docstring).
    """

    def __init__(self, dtype: torch.dtype | None = None, frozen: bool = True,
                 *, device=None, generator: torch.Generator | None = None,
                 trunk_int8: Any = False,
                 fused_plan: Tuple[str, ...] = DEFAULT_PLAN,
                 fused_trunk: bool | None = None, stem: str = "conv7",
                 stem_cpad: bool = False):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.frozen = frozen
        self.int8_plan = parse_int8_plan(trunk_int8)
        self.fused_plan = parse_fused_plan(fused_plan)
        check_stem(stem)
        if fused_trunk and (not frozen or self.dtype != torch.bfloat16):
            raise ValueError(
                "fused_trunk=True (the JAX package's MMB_FUSED_TRUNK=1) needs "
                "a frozen trunk computing in bf16: the folded path runs BN on "
                "running statistics and without gradients")
        self.fused_trunk = fused_trunk
        self.stem_mode = stem
        self.stem_cpad = stem_cpad
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
                                         device=device,
                                         fused_epilogue=False))
                in_ch = planes * EXPANSION
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*layer))
        if any(self.int8_plan):
            def amax():
                return torch.zeros((), device=device)
            self.register_buffer("stem_amax", amax())
            for stage_idx, q in enumerate(self.int8_plan):
                for block in getattr(self, f"layer{stage_idx + 1}"):
                    if q == "q":
                        block.register_buffer("h1_amax", amax())
                        block.register_buffer("h2_amax", amax())
                    block.register_buffer("out_amax", amax())
        self._fold_key: tuple | None = None
        self._folded: List[Tuple[Dict[str, torch.Tensor], int]] = []
        self._fold_amax: Tuple[torch.Tensor | None, torch.Tensor | None] = (
            None, None)
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
        """NCHW x (3 or 12 channels) -> the stem convolution + BN + ReLU +
        maxpool 3/2 (pad 1), NCHW; the convolution's form as the JAX
        package picks it: the 4x4 form for a 12-channel input, or with
        ``stem="s2d"`` at bf16 and even H and W; else the 7x7, its input
        channels padded with ``stem_cpad``."""
        H, W = x.shape[2:]
        if x.shape[1] == 12:
            y = self._stem_from_s2d(x)
        elif (self.stem_mode == "s2d" and x.dtype == torch.bfloat16
              and H % 2 == 0 and W % 2 == 0):
            y = self._stem_from_s2d(
                space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
        elif self.stem_cpad and x.shape[1] == 3:
            x = F.pad(x, (0, 0, 0, 0, 0, 5))
            w = F.pad(self.conv1.weight.to(x.dtype), (0, 0, 0, 0, 0, 5))
            y = F.conv2d(x, _like(w, x), stride=2, padding=3)
        else:
            y = self.conv1(x, stride=2, padding=3)
        y = self.bn1.forward_relu(y, batch_stats)
        return F.max_pool2d(y, 3, stride=2, padding=1)

    def _stem_from_s2d(self, xs: torch.Tensor) -> torch.Tensor:
        """The 7x7 stride-2 convolution as a 4x4 stride-1 one on the
        space-to-depth NCHW ``xs`` [B, 12, H/2, W/2] ((i, j, c) channel
        order; the JAX package's ``_stem_from_s2d``). The weight, padded to
        8x8 at the top and left (tap d = 2k + i - 1; d = -1 is the zero
        row or column), becomes [64, 12, 4, 4] in (i, j, c) order; 12 -> 16
        channels with ``stem_cpad``. The JAX package pads the input
        asymmetrically, ((2, 1), (2, 1)), which ``F.conv2d`` cannot say:
        it pads 2 on every side here and drops the output's last row and
        column, the only outputs that read the extra pad. That costs 1.8%
        more products and no copy of the input, where ``F.pad`` would
        copy it."""
        w = F.pad(self.conv1.weight.to(xs.dtype), (1, 0, 1, 0))
        w = w.reshape(64, 3, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        w = w.reshape(64, 12, 4, 4)
        if self.stem_cpad:
            xs = F.pad(xs, (0, 0, 0, 0, 0, 4))
            w = F.pad(w, (0, 0, 0, 0, 0, 4))
        return F.conv2d(xs, _like(w, xs), padding=2)[:, :, :-1, :-1]

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        applies = (not train and self.dtype == torch.bfloat16)
        if self.fused_trunk is None:
            folded = applies and self.frozen and x.is_cuda
        elif self.fused_trunk and not applies:
            raise ValueError(
                "fused_trunk=True (MMB_FUSED_TRUNK=1) needs BN on running "
                "statistics: the folded path cannot run a train-mode "
                "BatchNorm")
        else:
            folded = self.fused_trunk
        if folded:
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
        """The folded path in x's dtype: BN on running statistics, the
        stages run as ``int8_plan`` and ``fused_plan`` say. An int8 plan
        runs in bf16 unless the batch is a multiple of 32, as in the JAX
        package."""
        with torch.no_grad():
            y = self.stem(_nchw_view(x))
            y = y.permute(0, 2, 3, 1).contiguous()  # no copy: channels-last
            plan = (self.int8_plan if y.shape[0] % INT8_BATCH == 0
                    else (False,) * len(RESNEXT50_STAGES))
            folded = self.folded(x.dtype, plan)
            entry_amax, out_amax = self._fold_amax
            i = 0
            for stage_idx, (_, n_blocks, _) in enumerate(RESNEXT50_STAGES):
                fws = [fw for fw, _ in folded[i:i + n_blocks]]
                strides = [s for _, s in folded[i:i + n_blocks]]
                i += n_blocks
                q = plan[stage_idx]
                if q and not (stage_idx and plan[stage_idx - 1]):
                    # the bf16 -> int8 boundary (or the stem, for stage 1)
                    y = quantize_activation(y, entry_amax)
                y = _run_stage(y, fws, strides,
                               _stage_mode(self.fused_plan[stage_idx], q))
            if plan[-1]:
                # dequantize: pool in f32, the map in the compute dtype
                y_f = y.float() * activation_scale(out_amax)
                return {"pooled": y_f.mean(dim=(1, 2)),
                        "feature_map": y_f.to(x.dtype)}
        return self._outputs(y)

    @staticmethod
    def _outputs(fmap: torch.Tensor) -> Dict[str, torch.Tensor]:
        # pool in f32; the map stays in the compute dtype
        return {"pooled": fmap.float().mean(dim=(1, 2)),
                "feature_map": fmap}

    def folded(self, dtype: torch.dtype, int8_plan: Tuple[Any, ...] = None
               ) -> List[Tuple[Dict[str, torch.Tensor], int]]:
        """Every block's folded weights and stride, computed once per weight
        state: the cache key holds the plan and each tensor's storage and
        version counter, so an in-place update (a loaded state dict, BN
        statistics updated in batch mode, a calibration) refolds, and
        frozen weights fold once. Blocks of the plan's int8 stages are
        quantized (``fold_block_params_q``), those of its transport stages
        folded for int8 codes with products in ``dtype``
        (``fold_block_params_t``), the others folded in ``dtype``. Sets
        ``_fold_amax``: the activation range at the bf16 -> int8 boundary
        and at the trunk's output (None, None for a bf16 plan)."""
        plan = self.int8_plan if int8_plan is None else tuple(int8_plan)
        tensors = [t for b in self.blocks()
                   for t in (*b.parameters(), *b.buffers())]
        if any(plan):
            tensors += [self.stem_amax, self.bn1.weight, self.bn1.bias]
        key = (dtype, plan, *((t.data_ptr(), t._version) for t in tensors))
        if key != self._fold_key:
            with torch.no_grad():
                self._folded, self._fold_amax = self._fold_chain(dtype, plan)
            self._fold_key = key
        return self._folded

    def _fold_chain(self, dtype, plan):
        """The JAX package's fold phase (``_fused_stages``): bf16 folds, and
        with any int8 stage the activation-range chain from the stem's
        range through every block's output range, each the calibrated
        value or the BatchNorm bound."""
        folded = []
        amax = entry = None
        if any(plan):
            amax = entry = resolve_amax(self.stem_amax, self.bn1.weight,
                                        self.bn1.bias)
        for stage_idx, q in enumerate(plan):
            if q and not (stage_idx and plan[stage_idx - 1]):
                entry = amax  # the first int8 stage's input range
            for b in getattr(self, f"layer{stage_idx + 1}"):
                sd = b.state_dict()
                if q == "t":
                    out_amax = _block_out_amax(b, amax)
                    fw = fold_block_params_t(sd, amax, out_amax, dtype)
                    amax = out_amax
                elif q:
                    out_amax = _block_out_amax(b, amax)
                    fw = fold_block_params_q(
                        sd, amax, resolve_amax(b.h1_amax, b.bn1.weight,
                                               b.bn1.bias),
                        resolve_amax(b.h2_amax, b.bn2.weight, b.bn2.bias),
                        out_amax)
                    amax = out_amax
                else:
                    fw = fold_block_params(sd, dtype)
                    if amax is not None:
                        amax = _block_out_amax(b, amax)
                folded.append((fw, b.stride))
        return folded, (entry, amax)


def _block_out_amax(block: BottleneckX, in_amax: torch.Tensor
                    ) -> torch.Tensor:
    """A block's output range: the calibrated ``out_amax`` where set, else
    the bn3 bound plus the incoming range (the residual sum)."""
    return torch.where(block.out_amax > 0, block.out_amax,
                       bn_amax_bound(block.bn3.weight, block.bn3.bias)
                       + in_amax)


def _stage_mode(mode: str, q: Any) -> str:
    """The plan's mode for a stage; an int8 ("q") stage runs "bandedN" as
    "blocks" and "splitbandN" as "split", as the JAX package demotes them
    (its banded kernel takes no int8 dots); transport ("t") stages stay
    banded."""
    if q == "q" and mode.startswith("banded"):
        return "blocks"
    if q == "q" and mode.startswith("splitband"):
        return "split"
    return mode


def _run_stage(y: torch.Tensor, fws: List[Dict[str, torch.Tensor]],
               strides: List[int], mode: str) -> torch.Tensor:
    """One stage's blocks on NHWC ``y`` through the kernels ``mode`` names
    (the chain of the JAX package's ``_fused_stages``)."""
    if mode.startswith("splitband") or mode == "split":
        y = fused_bottleneck(y, fws[0], strides[0])
        fws, strides = fws[1:], strides[1:]
        if not fws:
            return y
        if mode == "split":
            return fused_stage(y, fws, strides)
        ho = y.shape[1]
        band = min(_band_rows(mode, "splitband"), ho)
        # the band must tile the tail's output rows
        return (fused_stage(y, fws, strides) if ho % band
                else fused_stage_banded(y, fws, strides, band))
    if mode == "full":
        return fused_stage(y, fws, strides)
    if mode.startswith("banded"):
        ho = (y.shape[1] - 1) // strides[0] + 1
        band = min(_band_rows(mode, "banded"), ho)
        if ho % band == 0:
            return fused_stage_banded(y, fws, strides, band)
        mode = "blocks"  # the band does not tile the output rows
    assert mode == "blocks", mode
    for fw, s in zip(fws, strides):
        y = fused_bottleneck(y, fw, s)
    return y
