"""int8 quantization of the frozen ResNeXt trunk (counterpart of
``multimodal_baby_tpu/ops/quant.py``, its "q" mode).

Weights are per-output-channel symmetric int8 (BatchNorm folded first, so
the scales absorb its multiply); activations are per-tensor int8 codes of
ReLU outputs, in [0, 127], with the scale amax / 127. The amax values come
from calibration (``models/quant_calib.py``) or, where a value is 0
(uncalibrated), from the folded BatchNorm: a post-BN channel is about
N(beta, gamma^2), so amax <~ max |beta| + K_SIGMA |gamma|.

Requantization folds into one per-channel multiply-add on the int32 sum:

    h_q = clip(round(acc * a_c + b_c), 0, 127)
    a_c = s_in * s_w_c / s_out,  b_c = bias_c / s_out

``bottleneck_reference_q`` is K2's plain version. Its dots are exact: the
int8 products are summed in float64 (exact for |sum| < 2**53; the trunk's
largest, 127 * 127 * 2048, is about 3.3e7), then converted to f32 as the
int32 sum would be. Every rounding is half to even (``torch.round``, as
``jnp.round`` and CUDA's ``rintf``), the multiply and the add each rounded
once. The grouped weight stays compact, ``[3, 3, cg, W]``.

The int8-transport mode ("t", K10a) passes int8 codes between blocks but
multiplies in bf16: ``fold_block_params_t`` folds the input scale into w1
and wd and the output scale into the conv3 and downsample epilogues, and
``bottleneck_reference_t`` is its plain version.

``int8_dense`` is the ViT's int8 Dense (the JAX package's
``int8_dense``, its ``MMB_VIT_INT8`` mode): weights per output channel and
activations per tensor, both symmetric, the activation's range taken from
the tensor itself on every call. It is a library product on the card
(``torch._int_mm``), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.ops.bottleneck import (
    _bn_fold, _conv1, _grouped)

__all__ = ["K_SIGMA", "activation_scale", "quantize_weight",
           "quantize_activation", "bn_amax_bound", "resolve_amax",
           "fold_block_params_q", "bottleneck_reference_q",
           "fold_block_params_t", "bottleneck_reference_t",
           "dense_weight_codes", "quantize_dynamic", "int8_dense"]

K_SIGMA = 4.0  # uncalibrated fallback: amax = max|beta| + K_SIGMA*|gamma|

Folded = Dict[str, torch.Tensor]


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, correctly rounded on every device: CUDA divides by a
    host-side Python number as a multiply by its reciprocal, which can be
    an ulp off the quotient that the CPU and the JAX package compute, and
    so move a code; a divisor on x's device is divided by."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def activation_scale(amax) -> torch.Tensor:
    """Per-tensor activation scale max(amax, 1e-12) / 127, in f32."""
    return _div127(torch.as_tensor(amax, dtype=torch.float32).clamp_min(1e-12))


def quantize_weight(w: torch.Tensor, axis: int = -1):
    """Per-output-channel symmetric int8: returns (w_q, scale[C]) with
    scale = max(amax, 1e-12) / 127 over every axis but ``axis``."""
    w = w.float()
    axis %= w.dim()
    red = [i for i in range(w.dim()) if i != axis]
    scale = _div127(w.abs().amax(dim=red).clamp_min(1e-12))
    shape = [1] * w.dim()
    shape[axis] = -1
    w_q = torch.round(w / scale.reshape(shape)).clamp(-127, 127)
    return w_q.to(torch.int8), scale


def quantize_activation(x: torch.Tensor, amax) -> torch.Tensor:
    """ReLU output -> int8 codes in [0, 127] with scale amax / 127."""
    q = torch.round(x.float() / activation_scale(amax))
    return q.clamp(0, 127).to(torch.int8)


def bn_amax_bound(weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Data-free activation bound from a BatchNorm's affine parameters."""
    return (bias.float().abs() + K_SIGMA * weight.float().abs()).max()


def resolve_amax(calibrated: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The calibrated value where it is set (> 0), else the BN bound."""
    calibrated = torch.as_tensor(calibrated, dtype=torch.float32,
                                 device=weight.device)
    return torch.where(calibrated > 0, calibrated,
                       bn_amax_bound(weight, bias))


def fold_block_params_q(sd: Dict[str, torch.Tensor], in_amax, h1_amax,
                        h2_amax, out_amax) -> Folded:
    """Fold running BatchNorm into one ``BottleneckX`` block and quantize it.

    ``sd`` is the block's state dict (torch names, as
    ``ops.bottleneck.fold_block_params`` takes it). Returns int8 ``w1
    [W, Cin]``, ``w2 [3, 3, cg, W]``, ``w3 [Cout, W]`` and f32 ``a1/b1,
    a2/b2 [W]``, ``a3/b3 [Cout]``, then ``wd [Cout, Cin]`` int8 with
    ``ad/bd`` for a block with a downsample, else ``ai [Cout]`` (the
    identity's dequantize-requantize factor s_in / s_out). The 1x1
    weights are output-major (torch's conv layout, the JAX package's
    transposed): each output channel's K bytes are contiguous, as the
    Hopper int8 GEMM reads its B operand."""
    s_in, s_h1, s_h2, s_out = map(activation_scale,
                                  (in_amax, h1_amax, h2_amax, out_amax))
    out: Folded = {}

    def conv(name, mul, add, s_a, s_b, key, perm):
        w = sd[f"{name}.weight"].float().permute(*perm) * mul
        w_q, sw = quantize_weight(w)
        out[f"w{key}"] = w_q.contiguous()
        out[f"a{key}"] = (s_a * sw / s_b).contiguous()
        out[f"b{key}"] = (add / s_b).contiguous()

    one_by_one = (2, 3, 1, 0)   # [O, I, 1, 1] -> [1, 1, I, O]
    mul1, add1 = _bn_fold(sd, "bn1")
    conv("conv1", mul1, add1, s_in, s_h1, "1", one_by_one)
    out["w1"] = out["w1"][0, 0].t().contiguous()
    mul2, add2 = _bn_fold(sd, "bn2")
    conv("conv2", mul2, add2, s_h1, s_h2, "2", (2, 3, 1, 0))
    mul3, add3 = _bn_fold(sd, "bn3")
    conv("conv3", mul3, add3, s_h2, s_out, "3", one_by_one)
    out["w3"] = out["w3"][0, 0].t().contiguous()
    cout = out["w3"].shape[0]
    if "downsample.0.weight" in sd:
        muld, addd = _bn_fold(sd, "downsample.1")
        conv("downsample.0", muld, addd, s_in, s_out, "d", one_by_one)
        out["wd"] = out["wd"][0, 0].t().contiguous()
    else:
        out["ai"] = torch.full((cout,), float(s_in / s_out),
                               dtype=torch.float32,
                               device=out["w3"].device)
    return out


def _exact_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 . [N, K] int8 (output-major) -> [M, N], summed exactly
    (float64)."""
    return a.double() @ w.double().t()


def _exact_grouped_conv(h: torch.Tensor, w2: torch.Tensor, stride: int
                        ) -> torch.Tensor:
    """The 32-group 3x3 (pad 1) on NHWC int8 codes with the compact int8
    weight [3, 3, cg, W], summed exactly: nine tap products in float64 (a
    library convolution may take a transform that rounds)."""
    B, H, W, width = h.shape
    cg = w2.shape[2]
    groups = width // cg
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    hp = F.pad(h.double(), (0, 0, 1, 1, 1, 1))
    # [3, 3, cg, G, cg_out] -> per tap [G, cg_in, cg_out]
    wg = w2.double().reshape(3, 3, cg, groups, cg).permute(0, 1, 3, 2, 4)
    acc = 0
    for ky in range(3):
        for kx in range(3):
            tap = hp[:, ky:ky + stride * (Ho - 1) + 1:stride,
                     kx:kx + stride * (Wo - 1) + 1:stride, :]
            tap = tap.reshape(-1, groups, cg).transpose(0, 1)  # [G, M, cg]
            acc = acc + torch.bmm(tap, wg[ky, kx])
    return acc.transpose(0, 1).reshape(B, Ho, Wo, width)


def _requant(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    return torch.round(acc.float() * a + b).clamp(0, 127).to(torch.int8)


def bottleneck_reference_q(x_q: torch.Tensor, fw: Folded, *,
                           stride: int = 1) -> torch.Tensor:
    """K2's plain version: one int8 block, NHWC ``[B, H, W, C]`` codes in and
    out, with the folded weights of ``fold_block_params_q``."""
    B, H, W, cin = x_q.shape
    width = fw["w1"].shape[0]
    h1 = _requant(_exact_dot(x_q.reshape(-1, cin), fw["w1"]), fw["a1"],
                  fw["b1"]).reshape(B, H, W, width)
    acc2 = _exact_grouped_conv(h1, fw["w2"], stride)
    Ho, Wo = acc2.shape[1:3]
    h2 = _requant(acc2.reshape(-1, width), fw["a2"], fw["b2"])
    y = _exact_dot(h2, fw["w3"]).float() * fw["a3"] + fw["b3"]
    x_id = x_q[:, ::stride, ::stride, :].reshape(-1, cin)
    if "wd" in fw:
        ident = _exact_dot(x_id, fw["wd"]).float() * fw["ad"] + fw["bd"]
    else:
        ident = x_id.float() * fw["ai"]
    out = torch.round(y + ident).clamp(0, 127).to(torch.int8)
    return out.reshape(B, Ho, Wo, -1)


def fold_block_params_t(sd: Dict[str, torch.Tensor], in_amax, out_amax,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> Folded:
    """Fold running BatchNorm into one ``BottleneckX`` block for int8
    transport (the JAX package's ``fold_block_params_t``): int8 codes in
    and out, products in ``compute_dtype``.

    Returns, in ``ops.bottleneck.fold_block_params``'s layouts, ``w1 [Cin,
    W]`` scaled by the input scale s_in, the compact ``w2 [3, 3, cg, W]``,
    ``w3 [W, Cout]`` in ``compute_dtype``; f32 ``b1, b2 [W]``, ``a3 = 1 /
    s_out`` and ``b3 = add3 / s_out [Cout]``; then ``wd [Cin, Cout]``
    scaled by s_in with ``ad = 1 / s_out``, ``bd = addd / s_out`` for a
    block with a downsample, else ``ai = s_in / s_out [Cout]``."""
    dev = sd["bn1.weight"].device
    s_in = activation_scale(in_amax).to(dev)
    s_out = activation_scale(out_amax).to(dev)

    def cast(w):
        return w.to(compute_dtype).contiguous()

    mul1, add1 = _bn_fold(sd, "bn1")
    mul2, add2 = _bn_fold(sd, "bn2")
    mul3, add3 = _bn_fold(sd, "bn3")
    cout = mul3.shape[0]
    ones = torch.ones(cout, dtype=torch.float32, device=dev)
    out = {
        "w1": cast(sd["conv1.weight"][:, :, 0, 0].float().t() * mul1 * s_in),
        "b1": add1.contiguous(),
        "w2": cast(sd["conv2.weight"].float().permute(2, 3, 1, 0) * mul2),
        "b2": add2.contiguous(),
        "w3": cast(sd["conv3.weight"][:, :, 0, 0].float().t() * mul3),
        "a3": ones / s_out,
        "b3": (add3 / s_out).contiguous(),
    }
    if "downsample.0.weight" in sd:
        muld, addd = _bn_fold(sd, "downsample.1")
        out["wd"] = cast(sd["downsample.0.weight"][:, :, 0, 0].float().t()
                         * muld * s_in)
        out["ad"] = ones / s_out
        out["bd"] = (addd / s_out).contiguous()
    else:
        out["ai"] = (ones * (s_in / s_out)).contiguous()
    return out


def bottleneck_reference_t(x_q: torch.Tensor, fw: Folded, *,
                           stride: int = 1) -> torch.Tensor:
    """K10a's plain version: one int8-transport block, NHWC ``[B, H, W, C]``
    int8 codes in and out, with the weights of ``fold_block_params_t``.
    Sums in f32; h1 and h2 rounded to the weights' dtype, as the TPU kernel
    keeps them (the JAX package's ``bottleneck_reference_t`` keeps them in
    f32: the two agree at f32 weights); the output is
    ``clip(round((h2 . w3) * a3 + b3 + identity), 0, 127)`` with identity
    ``(x . wd) * ad + bd`` or ``x * ai``."""
    B, H, W, cin = x_q.shape
    mid = fw["w1"].dtype
    f32 = torch.float32
    h2 = _grouped(_conv1(x_q, fw, mid), fw, stride, mid)
    Ho, Wo, width = h2.shape[1:]
    y = (h2.reshape(-1, width).to(f32) @ fw["w3"].to(f32)) * fw["a3"] \
        + fw["b3"]
    x_id = x_q[:, ::stride, ::stride, :].reshape(-1, cin).to(f32)
    if "wd" in fw:
        ident = (x_id @ fw["wd"].to(f32)) * fw["ad"] + fw["bd"]
    else:
        ident = x_id * fw["ai"]
    out = torch.round(y + ident).clamp(0, 127).to(torch.int8)
    return out.reshape(B, Ho, Wo, -1)


# ---------------------------------------------------------------------------
# int8 Dense for the frozen ViT trunk
# ---------------------------------------------------------------------------

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes M > 16 rows


def dense_weight_codes(weight: torch.Tensor):
    """A Dense weight in torch's layout ``[out, in]`` -> (int8 codes
    ``[out, in]``, f32 scale ``[out]``): per output channel, symmetric, from
    the f32 values (the JAX package quantizes its ``[in, out]`` kernel over
    axis 0: the same codes, transposed)."""
    return quantize_weight(weight, axis=0)


def quantize_dynamic(x: torch.Tensor):
    """x -> (int8 codes, f32 scale): per tensor, symmetric, the scale
    max(amax |x|, 1e-12) / 127 of this x, the codes round half to even,
    clipped to +-127."""
    xf = x.float()
    scale = _div127(xf.abs().amax().clamp_min(1e-12))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_dense(x: torch.Tensor, w_codes: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x W^T (+ bias) through int8 products (the JAX package's
    ``int8_dense``): x ``[..., K]`` float, quantized here per tensor
    (``quantize_dynamic``); ``w_codes [N, K]`` and ``w_scale [N]`` from
    ``dense_weight_codes`` (a frozen trunk computes them once per weight
    state). The int32 sums are dequantized as ``acc * (w_scale * a_scale)
    + bias`` in f32, then cast to ``out_dtype`` (x's by default). The
    rounding has no gradient: frozen weights only.

    On a CUDA tensor the product is ``torch._int_mm`` (K and N multiples of
    8; fewer than 17 rows are padded with zero rows); on a CPU tensor the
    same arithmetic with the int8 products summed exactly in float64. The
    JAX package's ``amax_rows`` restricts the activation range to the real
    tokens of a tile-padded token stream (``MMB_VIT_PADSEQ``), which the
    port does not carry over: the port has no pad tokens."""
    K = x.shape[-1]
    N = w_codes.shape[0]
    x_q, a_scale = quantize_dynamic(x)
    rows = x_q.reshape(-1, K)
    if x.device.type == "cuda":
        if K % 8 or N % 8:
            raise ValueError(f"int8_dense: torch._int_mm needs K and N "
                             f"multiples of 8, got K={K}, N={N}")
        m = rows.shape[0]
        if m < INT_MM_MIN_ROWS:
            rows = F.pad(rows, (0, 0, 0, INT_MM_MIN_ROWS - m))
        acc = torch._int_mm(rows, w_codes.t())[:m].float()
    elif x.device.type == "cpu":
        acc = _exact_dot(rows, w_codes).float()
    else:
        raise ValueError(f"int8_dense: no int8 product for device {x.device}")
    y = acc * (w_scale * a_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)
