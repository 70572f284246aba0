"""BatchNorm on batch statistics as one hand-written kernel pair (K12) for
the PyTorch port.

The conv path of the ResNeXt-50 trunk trained with ``frozen_bn="batch"``
(the published recipe) normalises each convolution's output with the
batch's own statistics. Over NHWC pixels flattened to rows, x [M, C]:

    statistics: mean = E[x], var = max(E[x^2] - mean^2, 0) over f32 x
                (the kernel adds its f32 partial sums in f64),
                fold = [mul, add] [2, C] with mul = weight * rsqrt(var +
                eps) and add = bias - mean * mul, running = 0.9 * running
                + 0.1 * batch (the biased variance)
    apply:      out = relu(x * mul + add [+ r]), r the block's identity or
                its downsample normalised in the same pass (d * mul_d +
                add_d, its own fold), in f32 with one rounding to x's dtype

``batch_norm_stats`` and ``batch_norm_apply`` run the hand-written Hopper
kernels (``csrc/batch_norm.cu``, launch geometry ``batch_norm_geometry``)
on CUDA tensors (bf16 x, f32 vectors, C % 8 == 0) and their plain versions
(``batch_norm_stats_reference``, ``batch_norm_apply_reference``) on CPU
tensors. No TPU kernel stands behind them: the JAX package leaves this
BatchNorm to XLA, which fuses it. Neither has a gradient: the trunk routes
here only where none is needed (``models/vision_resnext.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.bottleneck import BN_EPS

__all__ = ["BN_MOMENTUM", "batch_moments", "update_running",
           "batch_norm_stats_reference", "batch_norm_apply_reference",
           "batch_norm_geometry", "batch_norm_stats", "batch_norm_apply"]

BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch
THREADS = 256      # a block of either kernel
MAX_COLUMNS = 16   # 16-byte vectors (8 channels each) of a row a block covers
STATS_PER_SM = 2   # the statistics grid: one wave of 2 blocks an SM
APPLY_PER_SM = 4   # the apply grid: one wave of 4 blocks an SM


def batch_moments(xf: torch.Tensor, dims: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) of f32 ``xf`` over ``dims``, the variance as
    E[x^2] - E[x]^2 clamped at 0."""
    mean = xf.mean(dim=dims)
    var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
    return mean, var


def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor) -> None:
    """The running buffers in place, with momentum 0.9 and the biased batch
    variance, as flax's ``nn.BatchNorm`` (torch's own BatchNorm would take
    the unbiased one)."""
    with torch.no_grad():
        running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)


def batch_norm_stats_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor,
                               running_mean: torch.Tensor,
                               running_var: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The statistics kernel's plain version: x [M, C]; returns the fold
    [mul, add] [2, C] f32 and updates the running buffers."""
    mean, var = batch_moments(x.float(), (0,))
    update_running(running_mean, running_var, mean, var)
    mul = torch.rsqrt(var + BN_EPS) * weight.float()
    return torch.stack((mul, bias.float() - mean * mul))


def batch_norm_apply_reference(x: torch.Tensor, fold: torch.Tensor,
                               residual: Optional[torch.Tensor] = None,
                               fold_r: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The apply kernel's plain version: relu(x * mul + add + r) in f32,
    (mul, add) = fold, rounded once to x's dtype; r = residual * mul_r +
    add_r where a second fold (mul_r, add_r) = fold_r is given, else
    residual (or nothing)."""
    y = x.float() * fold[0] + fold[1]
    if residual is not None:
        r = residual.float()
        y = y + (r if fold_r is None else r * fold_r[0] + fold_r[1])
    return torch.relu(y).to(x.dtype)


class BatchNormGeometry(NamedTuple):
    """Both kernels' launch over x [M, C]: a block covers ``columns``
    16-byte vectors (8 channels each) of ``rows_at_once`` rows at a time;
    ``ranges`` channel ranges make the grid's y. The statistics grid's x is
    ``slabs`` row slabs of ``slab_rows`` rows (one partial row each, the
    last slab ragged); the apply grid's x is ``apply_blocks`` blocks that
    walk the rows."""
    columns: int
    rows_at_once: int
    ranges: int
    slabs: int
    slab_rows: int
    apply_blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def batch_norm_geometry(M: int, C: int, sms: int = 132
                        ) -> BatchNormGeometry:
    """K12's launch for M rows of C channels on a card of ``sms`` SMs (132
    on an H100 SXM): each grid as many blocks as fill one wave
    (STATS_PER_SM, APPLY_PER_SM blocks an SM), fewer where the rows run
    out. Raises ValueError on what the kernels cannot take: M < 1, C < 8,
    C % 8 != 0."""
    if M < 1 or C < 8 or C % 8:
        raise ValueError(f"batch_norm_geometry: needs M >= 1 and C a "
                         f"positive multiple of 8; got M={M}, C={C}")
    vectors = C // 8
    columns = min(vectors, MAX_COLUMNS)
    rows_at_once = THREADS // columns
    ranges = _cdiv(vectors, columns)
    steps = _cdiv(M, rows_at_once)
    slabs = min(_cdiv(sms * STATS_PER_SM, ranges), steps)
    slab_rows = _cdiv(steps, slabs) * rows_at_once
    return BatchNormGeometry(columns, rows_at_once, ranges,
                             _cdiv(M, slab_rows), slab_rows,
                             min(_cdiv(sms * APPLY_PER_SM, ranges), steps))


@functools.lru_cache(maxsize=256)
def _card_geometry(M: int, C: int, index: int) -> BatchNormGeometry:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return batch_norm_geometry(M, C, sms)


def _check(what: str, x: torch.Tensor, vectors, rows=(), folds=()) -> None:
    """x [M, C] bf16 and each of ``rows`` the same, each of ``vectors`` [C]
    f32 and of ``folds`` [2, C] f32: on x's device, contiguous, 16-byte
    aligned. Raises ValueError
    naming the first that is not; the messages are built only then (this
    runs twice a BatchNorm on the train step's host path)."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [M, C], got {tuple(x.shape)}")
    M, C = x.shape
    if M < 1 or C < 8 or C % 8 or M * C >= 2**40:
        raise ValueError(f"{what}: needs M >= 1, C a positive multiple of 8 "
                         f"and M * C < 2**40; got M={M}, C={C}")
    device = x.device
    for kind, shape, dtype, named in (("row", (M, C), torch.bfloat16,
                                       (("x", x), *rows)),
                                      ("vector", (C,), torch.float32,
                                       vectors),
                                      ("fold", (2, C), torch.float32,
                                       folds)):
        for name, t in named:
            if t.shape != shape or t.dtype != dtype:
                raise ValueError(
                    f"{what}: {name} must be {shape} {dtype}, got "
                    f"{tuple(t.shape)} {t.dtype}")
            if t.device != device:
                raise ValueError(f"{what}: {name} is on {t.device}, x on "
                                 f"{device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be contiguous and "
                                 f"16-byte aligned")


def batch_norm_stats(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor
                     ) -> torch.Tensor:
    """The fold [mul, add] [2, C] f32 of BatchNorm on x's batch statistics,
    x [M, C]; ``running_mean`` and ``running_var`` updated in place.

    On CUDA tensors (bf16 x; f32 weight, bias and buffers) this launches
    the statistics kernel and raises on anything it cannot take; on CPU
    tensors it runs ``batch_norm_stats_reference``. No gradient.
    ``batch_norm_stats.launches`` counts launches."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return batch_norm_stats_reference(x, weight, bias, running_mean,
                                              running_var)
        raise ValueError(f"batch_norm_stats: no kernel for device "
                         f"{x.device}")
    _check("batch_norm_stats", x, (
        ("weight", weight), ("bias", bias), ("running_mean", running_mean),
        ("running_var", running_var)))
    M, C = x.shape
    geo = _card_geometry(M, C, x.get_device())
    # the fold, then the slabs' partial sums: one allocation
    out = torch.empty((1 + geo.slabs, 2, C), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with _build.on_device(x.get_device()):
        stream, tickets = _build.sync_words("batch_norm", geo.ranges)
        code = lib.mmb_batch_norm_stats_bf16(
            x.data_ptr(), M, C, geo.columns, geo.slabs, geo.slab_rows,
            out.data_ptr() + 8 * C, tickets.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), out.data_ptr(), BN_EPS, BN_MOMENTUM,
            1 - BN_MOMENTUM, stream)
    _build.check(lib, code, "batch_norm_stats")
    # the kernel wrote the buffers behind autograd's back: their version
    # counters key the folded trunk's cache (``ResNeXt50.folded``)
    torch.autograd.graph.increment_version((running_mean, running_var))
    batch_norm_stats.launches += 1
    return out[0]


def batch_norm_apply(x: torch.Tensor, fold: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     fold_r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(x * mul + add [+ r]) in x's dtype, x [M, C], (mul, add) = fold
    [2, C]: r = residual * mul_r + add_r (a downsample's BatchNorm) where
    its fold (mul_r, add_r) = fold_r is given, else residual.

    On CUDA tensors (bf16 x and residual, f32 vectors) this launches the
    apply kernel and raises on anything it cannot take; on CPU tensors it
    runs ``batch_norm_apply_reference``. No gradient.
    ``batch_norm_apply.launches`` counts launches."""
    if fold_r is not None and residual is None:
        raise ValueError("batch_norm_apply: fold_r needs a residual")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return batch_norm_apply_reference(x, fold, residual, fold_r)
        raise ValueError(f"batch_norm_apply: no kernel for device "
                         f"{x.device}")
    folds = (("fold", fold),) if fold_r is None else (("fold", fold),
                                                      ("fold_r", fold_r))
    rows = () if residual is None else (("residual", residual),)
    _check("batch_norm_apply", x, (), rows, folds)
    M, C = x.shape
    geo = _card_geometry(M, C, x.get_device())
    out = torch.empty_like(x)
    mode = 0 if residual is None else (1 if fold_r is None else 2)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    lib = _build.library()
    with _build.on_device(x.get_device()):
        code = lib.mmb_batch_norm_apply_bf16(
            x.data_ptr(), ptr(residual), fold.data_ptr(), ptr(fold_r),
            out.data_ptr(), M, C, geo.columns, geo.apply_blocks, mode,
            torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(lib, code, "batch_norm_apply")
    batch_norm_apply.launches += 1
    return out


batch_norm_stats.launches = 0
batch_norm_apply.launches = 0
