"""The fused ResNeXt bottleneck block (K1 in bf16, K2 in int8) for the
PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/bottleneck_hwbc.py``: the
BatchNorm fold, the plain reference of one block, and ``fused_bottleneck``,
which runs the hand-written Hopper kernels in ``csrc/bottleneck.cu`` on a
CUDA tensor and the plain reference on a CPU tensor. The int8 fold and
plain version are in ``ops/quant.py``.

Layout is NHWC ``[B, H, W, C]`` at the public functions. The TPU's
``[H, B/16, W, 16, C]`` layout and the block-diagonal packing of the
grouped 3x3 weight (``pack_grouped_kernel``, for the TPU's 128-wide matrix
unit) are not carried over: the grouped weight stays in its compact form
``[3, 3, cg, W]`` (tap row, tap column, input channel within the group,
output channel), with cg = W / 32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.ops import _build

__all__ = ["fold_block_params", "unpack_grouped_kernel", "bottleneck_reference",
           "fused_bottleneck", "BN_EPS", "GROUPS"]

BN_EPS = 1e-5
GROUPS = 32
_PACK = 128  # block width of the TPU package's packed grouped weight

Folded = Dict[str, torch.Tensor]


def _bn_fold(sd: Dict[str, torch.Tensor], name: str):
    """(mul, add) in f32 for y = x * mul + add (running statistics)."""
    mul = sd[f"{name}.weight"].float() * torch.rsqrt(
        sd[f"{name}.running_var"].float() + BN_EPS)
    return mul, sd[f"{name}.bias"].float() - sd[f"{name}.running_mean"].float() * mul


def fold_block_params(sd: Dict[str, torch.Tensor],
                      compute_dtype: torch.dtype) -> Folded:
    """Fold running BatchNorm into one block's conv weights.

    ``sd`` is a ``BottleneckX`` state dict (reference names: ``conv1.weight``
    ``[W, Cin, 1, 1]``, ``bn1.{weight,bias,running_mean,running_var}``, ...,
    ``downsample.{0,1}.*``). Weights are folded in f32 and then cast to
    ``compute_dtype``; biases stay f32. Returns ``w1 [Cin, W]``,
    ``w2 [3, 3, cg, W]``, ``w3 [W, Cout]``, ``b1/b2 [W]``, ``b3 [Cout]``,
    and ``wd [Cin, Cout]``, ``bd [Cout]`` for a block with a downsample."""
    def cast(w):
        return w.to(compute_dtype).contiguous()

    mul1, add1 = _bn_fold(sd, "bn1")
    mul2, add2 = _bn_fold(sd, "bn2")
    mul3, add3 = _bn_fold(sd, "bn3")
    out = {
        "w1": cast(sd["conv1.weight"][:, :, 0, 0].float().t() * mul1),
        "b1": add1.contiguous(),
        "w2": cast(sd["conv2.weight"].float().permute(2, 3, 1, 0) * mul2),
        "b2": add2.contiguous(),
        "w3": cast(sd["conv3.weight"][:, :, 0, 0].float().t() * mul3),
        "b3": add3.contiguous(),
    }
    if "downsample.0.weight" in sd:
        muld, addd = _bn_fold(sd, "downsample.1")
        out["wd"] = cast(sd["downsample.0.weight"][:, :, 0, 0].float().t()
                         * muld)
        out["bd"] = addd.contiguous()
    return out


def unpack_grouped_kernel(packed: torch.Tensor, cg: int) -> torch.Tensor:
    """Inverse of the TPU package's ``pack_grouped_kernel``: the
    block-diagonal ``[9, W/128, 128, 128]`` form back to the compact
    ``[3, 3, cg, W]`` grouped weight. For the tests that hold the port's
    fold against the TPU package's."""
    nb = packed.shape[1]
    width = nb * _PACK
    co = torch.arange(width)
    ci = torch.arange(cg)
    rows = ((co // cg) * cg)[None, :] + ci[:, None]        # [cg, W] input ch.
    blocks = (co // _PACK)[None, :].expand(cg, width)
    w = packed[:, blocks, rows % _PACK, (co % _PACK)[None, :].expand(cg, width)]
    return w.reshape(3, 3, cg, width)


def bottleneck_reference(x: torch.Tensor, fw: Folded, *,
                         stride: int = 1) -> torch.Tensor:
    """One block in plain PyTorch, NHWC, with the kernel's rounding points:
    products accumulate in f32, h1 and h2 are rounded to ``x.dtype``, and
    the output is ``relu(y + identity)`` rounded to ``x.dtype``.

    Mirrors ``bottleneck_reference`` of the TPU package, except that the
    bias is added to the f32 accumulator before the first rounding, as the
    Pallas kernel does (that reference rounds each product to the input
    dtype first; at f32 the two are the same)."""
    B, H, W, cin = x.shape
    width = fw["w1"].shape[1]
    f32 = torch.float32
    h1 = torch.relu(x.reshape(-1, cin).to(f32) @ fw["w1"].to(f32) + fw["b1"])
    h1 = h1.to(x.dtype).reshape(B, H, W, width)
    w2 = fw["w2"].to(f32).permute(3, 2, 0, 1)              # [W, cg, 3, 3]
    h2 = F.conv2d(h1.to(f32).permute(0, 3, 1, 2), w2, stride=stride,
                  padding=1, groups=width // w2.shape[1])
    h2 = torch.relu(h2 + fw["b2"][:, None, None]).to(x.dtype)
    h2 = h2.permute(0, 2, 3, 1)
    Ho, Wo = h2.shape[1:3]
    y = h2.reshape(-1, width).to(f32) @ fw["w3"].to(f32) + fw["b3"]
    x_id = x[:, ::stride, ::stride, :].reshape(-1, cin).to(f32)
    if "wd" in fw:
        identity = x_id @ fw["wd"].to(f32) + fw["bd"]
    else:
        identity = x_id
    return torch.relu(y + identity).to(x.dtype).reshape(B, Ho, Wo, -1)


def block_dims(fw: Folded):
    """(width, Cout) of a folded block: bf16 1x1 weights are [K, N], the
    int8 ones output-major [N, K] (``ops.quant.fold_block_params_q``)."""
    axis = 0 if fw["w1"].dtype == torch.int8 else 1
    return fw["w1"].shape[axis], fw["w3"].shape[axis]


def _check_args(x: torch.Tensor, fw: Folded, stride: int,
                shape=None) -> None:
    """Raise ValueError on anything the CUDA kernels cannot take: a bf16
    block (K1) or an int8 block (K2: int8 codes and weights, f32 scales).
    ``shape`` stands for ``x.shape`` where a stage kernel feeds the block
    an intermediate of that shape."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_bottleneck: {msg}")

    shape = tuple(x.shape if shape is None else shape)
    need(len(shape) == 4, f"x must be [B, H, W, C], got {shape}")
    need(x.dtype in (torch.bfloat16, torch.int8),
         f"x must be bfloat16 or int8, got {x.dtype}")
    int8 = x.dtype == torch.int8
    need(stride in (1, 2), f"stride must be 1 or 2, got {stride}")
    cin = shape[3]
    width, cout = block_dims(fw)
    has_ds = "wd" in fw
    need(has_ds == ("bd" in fw), "wd and bd come together")
    shapes = {"w1": (cin, width), "w2": (3, 3, width // GROUPS, width),
              "w3": (width, cout), "b1": (width,), "b2": (width,),
              "b3": (cout,)}
    if has_ds:
        shapes.update(wd=(cin, cout), bd=(cout,))
    if int8:  # output-major 1x1 weights, and the scales
        for k in ("w1", "w3", "wd"):
            if k in shapes:
                shapes[k] = shapes[k][::-1]
        shapes.update(a1=(width,), a2=(width,), a3=(cout,))
        shapes["ad" if has_ds else "ai"] = (cout,)
    if not has_ds:
        need(stride == 1 and cin == cout,
             "a block without downsample needs stride 1 and Cin == Cout")
    need(sorted(fw) == sorted(shapes),
         f"weights must be {sorted(shapes)}, got {sorted(fw)}")
    for name, want_shape in shapes.items():
        t = fw[name]
        want = (torch.float32 if name[0] in "ab" else
                torch.int8 if int8 else torch.bfloat16)
        need(tuple(t.shape) == want_shape,
             f"{name} must be {want_shape}, got {tuple(t.shape)}")
        need(t.dtype == want, f"{name} must be {want}, got {t.dtype}")
    k_tile = 64 if int8 else 32
    need(cin % k_tile == 0 and width in (128, 256, 512, 1024)
         and cout % 128 == 0,
         f"needs Cin % {k_tile} == 0, W in (128, 256, 512, 1024), "
         f"Cout % 128 == 0; got Cin={cin}, W={width}, Cout={cout}")
    for name, t in [("x", x), *fw.items()]:
        need(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        need(t.is_contiguous(), f"{name} must be contiguous")
        need(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    need(shape[0] * shape[1] * shape[2] * max(cin, width, cout) < 2**31,
         "x is too large for 32-bit indexing")


def fused_bottleneck(x: torch.Tensor, fw: Folded, stride: int = 1
                     ) -> torch.Tensor:
    """One bottleneck block on NHWC ``x`` with folded weights ``fw``: bf16
    (or f32) activations with ``fold_block_params`` weights, or int8 codes
    with ``ops.quant.fold_block_params_q`` weights.

    On a CUDA tensor this launches the Hopper kernel (K1 for bf16, K2 for
    int8; shapes as ``_check_args`` states) and raises on anything it
    cannot take; it never falls back. On a CPU tensor it runs
    ``bottleneck_reference`` or ``ops.quant.bottleneck_reference_q``.
    ``fused_bottleneck.launches`` counts K1 launches,
    ``fused_bottleneck.launches_q`` K2 launches."""
    if x.device.type == "cpu":
        if x.dtype == torch.int8:
            from multimodal_baby_tpu_torch.ops.quant import (
                bottleneck_reference_q)
            return bottleneck_reference_q(x, fw, stride=stride)
        return bottleneck_reference(x, fw, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: no kernel for device {x.device}")
    _check_args(x, fw, stride)
    lib = _build.library()
    B, H, W, cin = x.shape
    width, cout = block_dims(fw)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    h1 = torch.empty((B, H, W, width), dtype=x.dtype, device=x.device)
    h2 = torch.empty((B, Ho, Wo, width), dtype=x.dtype, device=x.device)
    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)

    def ptr(name):
        t = fw.get(name)
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.int8:
            code = lib.mmb_bottleneck_s8(
                x.data_ptr(), *map(ptr, _Q_ORDER), h1.data_ptr(),
                h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout,
                stride, stream)
        else:
            code = lib.mmb_bottleneck_bf16(
                x.data_ptr(), *map(ptr, ("w1", "b1", "w2", "b2", "w3", "b3",
                                         "wd", "bd")),
                h1.data_ptr(), h2.data_ptr(), out.data_ptr(), B, H, W, cin,
                width, cout, stride, stream)
    _build.check(lib, code, "fused_bottleneck")
    if x.dtype == torch.int8:
        fused_bottleneck.launches_q += 1
    else:
        fused_bottleneck.launches += 1
    return out


# the int8 weights in the order of the kernels' C interfaces
_Q_ORDER = ("w1", "a1", "b1", "w2", "a2", "b2", "w3", "a3", "b3", "wd", "ad",
            "bd", "ai")

fused_bottleneck.launches = 0
fused_bottleneck.launches_q = 0
