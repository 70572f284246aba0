"""The fused ResNeXt bottleneck block (K1 in bf16, K2 in int8, K10a in int8
transport, K10b tile by tile) for the PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/bottleneck_hwbc.py``: the
BatchNorm fold, the plain reference of one block, ``fused_bottleneck``,
which runs the hand-written Hopper kernels in ``csrc/bottleneck.cu`` on a
CUDA tensor and the plain reference on a CPU tensor, and
``fused_bottleneck_tiles`` (the TPU package's tile mode). The int8 folds
and plain versions are in ``ops/quant.py``.

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
           "block_reference", "tiles_reference", "fused_bottleneck",
           "fused_bottleneck_tiles", "block_mode", "default_band", "BN_EPS",
           "GROUPS"]

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


def _conv1(x: torch.Tensor, fw: Folded, dtype: torch.dtype) -> torch.Tensor:
    """h1 = relu(x . w1 + b1) with f32 sums, rounded to ``dtype``; NHWC."""
    B, H, W, cin = x.shape
    f32 = torch.float32
    h1 = torch.relu(x.reshape(-1, cin).to(f32) @ fw["w1"].to(f32) + fw["b1"])
    return h1.to(dtype).reshape(B, H, W, -1)


def _grouped(h1: torch.Tensor, fw: Folded, stride: int, dtype: torch.dtype,
             rows=(1, 1)) -> torch.Tensor:
    """h2 = relu(grouped3x3(h1) + b2) rounded to ``dtype``, NHWC; ``rows``
    zero rows above and below h1 (the columns are padded by one)."""
    f32 = torch.float32
    w2 = fw["w2"].to(f32).permute(3, 2, 0, 1)              # [W, cg, 3, 3]
    h = F.pad(h1.to(f32).permute(0, 3, 1, 2), (0, 0, *rows))
    h2 = F.conv2d(h, w2, stride=stride, padding=(0, 1),
                  groups=w2.shape[0] // w2.shape[1])
    return torch.relu(h2 + fw["b2"][:, None, None]).to(dtype).permute(
        0, 2, 3, 1)


def _conv3(h2: torch.Tensor, x_id: torch.Tensor, fw: Folded,
           dtype: torch.dtype) -> torch.Tensor:
    """relu(h2 . w3 + b3 + identity) rounded to ``dtype``; x_id is the
    block input at the output pixels, NHWC."""
    B, Ho, Wo, width = h2.shape
    f32 = torch.float32
    y = h2.reshape(-1, width).to(f32) @ fw["w3"].to(f32) + fw["b3"]
    x_id = x_id.reshape(y.shape[0], -1).to(f32)
    if "wd" in fw:
        identity = x_id @ fw["wd"].to(f32) + fw["bd"]
    else:
        identity = x_id
    return torch.relu(y + identity).to(dtype).reshape(B, Ho, Wo, -1)


def bottleneck_reference(x: torch.Tensor, fw: Folded, *,
                         stride: int = 1) -> torch.Tensor:
    """One block in plain PyTorch, NHWC, with the kernel's rounding points:
    products accumulate in f32, h1 and h2 are rounded to ``x.dtype``, and
    the output is ``relu(y + identity)`` rounded to ``x.dtype``.

    Mirrors ``bottleneck_reference`` of the TPU package, except that the
    bias is added to the f32 accumulator before the first rounding, as the
    Pallas kernel does (that reference rounds each product to the input
    dtype first; at f32 the two are the same)."""
    h2 = _grouped(_conv1(x, fw, x.dtype), fw, stride, x.dtype)
    return _conv3(h2, x[:, ::stride, ::stride, :], fw, x.dtype)


def _out_size(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def tiles_reference(x: torch.Tensor, fw: Folded, stride: int, Bc: int,
                    hh: int) -> torch.Tensor:
    """K10b's plain version: ``bottleneck_reference`` computed tile by tile,
    as the kernel launches it: for each batch chunk of ``Bc`` images and
    each band of ``hh`` output rows, conv1 on the input rows the band
    needs (one halo row each side per stride-1 row, clipped to the image),
    zero rows for the grouped 3x3 outside the image, conv3 on the band."""
    B, H, W, _ = x.shape
    Ho = _out_size(H, stride)
    chunks = []
    for b0 in range(0, B, Bc):
        xb = x[b0:b0 + Bc]
        bands = []
        for lo in range(0, Ho, hh):
            need_lo, need_hi = lo * stride - 1, (lo + hh - 1) * stride + 2
            in_lo, in_hi = max(0, need_lo), min(H, need_hi)
            h1 = _conv1(xb[:, in_lo:in_hi], fw, x.dtype)
            h2 = _grouped(h1, fw, stride, x.dtype,
                          (in_lo - need_lo, need_hi - in_hi))
            x_id = xb[:, lo * stride:(lo + hh - 1) * stride + 1:stride,
                      ::stride]
            bands.append(_conv3(h2, x_id, fw, x.dtype))
        chunks.append(torch.cat(bands, dim=1))
    return torch.cat(chunks, dim=0)


def block_dims(fw: Folded):
    """(width, Cout) of a folded block: bf16 1x1 weights are [K, N], the
    int8 ones output-major [N, K] (``ops.quant.fold_block_params_q``)."""
    axis = 0 if fw["w1"].dtype == torch.int8 else 1
    return fw["w1"].shape[axis], fw["w3"].shape[axis]


def block_mode(x: torch.Tensor, fw: Folded) -> str:
    """The kernel a block takes, by (x dtype, w1 dtype): "bf16" (K1: bf16
    and bf16), "q" (K2: int8 codes, int8 weights) or "t" (K10a: int8 codes,
    bf16 weights from ``ops.quant.fold_block_params_t``). Raises on any
    other pair."""
    pair = (x.dtype, fw["w1"].dtype)
    modes = {(torch.bfloat16, torch.bfloat16): "bf16",
             (torch.int8, torch.int8): "q",
             (torch.int8, torch.bfloat16): "t"}
    if pair not in modes:
        raise ValueError(f"fused_bottleneck: no kernel for x {x.dtype} with "
                         f"weights {fw['w1'].dtype}")
    return modes[pair]


def _check_args(x: torch.Tensor, fw: Folded, stride: int,
                shape=None) -> None:
    """Raise ValueError on anything the CUDA kernels cannot take: a bf16
    block (K1), an int8 block (K2: int8 codes and weights, f32 scales) or an
    int8-transport block (K10a: int8 codes, bf16 weights, f32 biases and
    scales). ``shape`` stands for ``x.shape`` where a stage kernel feeds
    the block an intermediate of that shape."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_bottleneck: {msg}")

    shape = tuple(x.shape if shape is None else shape)
    need(len(shape) == 4, f"x must be [B, H, W, C], got {shape}")
    mode = block_mode(x, fw)
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
    if mode == "q":  # output-major 1x1 weights, and the scales
        for k in ("w1", "w3", "wd"):
            if k in shapes:
                shapes[k] = shapes[k][::-1]
        shapes.update(a1=(width,), a2=(width,))
    if mode != "bf16":
        shapes["a3"] = (cout,)
        shapes["ad" if has_ds else "ai"] = (cout,)
    if not has_ds:
        need(stride == 1 and cin == cout,
             "a block without downsample needs stride 1 and Cin == Cout")
    need(sorted(fw) == sorted(shapes),
         f"weights must be {sorted(shapes)}, got {sorted(fw)}")
    for name, want_shape in shapes.items():
        t = fw[name]
        want = (torch.float32 if name[0] in "ab" else
                torch.int8 if mode == "q" else torch.bfloat16)
        need(tuple(t.shape) == want_shape,
             f"{name} must be {want_shape}, got {tuple(t.shape)}")
        need(t.dtype == want, f"{name} must be {want}, got {t.dtype}")
    k_tile = 64 if mode == "q" else 32
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


def block_reference(x: torch.Tensor, fw: Folded, *,
                    stride: int = 1) -> torch.Tensor:
    """The plain version of the block ``fused_bottleneck`` runs, on x's
    device: ``bottleneck_reference`` for float x, and for int8 codes
    ``ops.quant.bottleneck_reference_q`` (int8 weights) or
    ``ops.quant.bottleneck_reference_t`` (transport)."""
    if x.dtype != torch.int8:
        return bottleneck_reference(x, fw, stride=stride)
    from multimodal_baby_tpu_torch.ops import quant
    ref = (quant.bottleneck_reference_q if fw["w1"].dtype == torch.int8
           else quant.bottleneck_reference_t)
    return ref(x, fw, stride=stride)


def _ptrs(fw: Folded, names):
    return [None if fw.get(k) is None else fw[k].data_ptr() for k in names]


def fused_bottleneck(x: torch.Tensor, fw: Folded, stride: int = 1
                     ) -> torch.Tensor:
    """One bottleneck block on NHWC ``x`` with folded weights ``fw``: bf16
    (or f32) activations with ``fold_block_params`` weights, int8 codes with
    ``ops.quant.fold_block_params_q`` weights, or int8 codes with
    ``ops.quant.fold_block_params_t`` (int8 transport) weights.

    On a CUDA tensor this launches the Hopper kernel the pair (x dtype, w1
    dtype) names (``block_mode``: K1, K2 or K10a; shapes as ``_check_args``
    states) and raises on anything it cannot take; it never falls back. On
    a CPU tensor it runs the plain version (``block_reference``).
    ``fused_bottleneck.launches`` counts K1 launches, ``.launches_q`` K2 and
    ``.launches_t`` K10a."""
    if x.device.type == "cpu":
        return block_reference(x, fw, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: no kernel for device {x.device}")
    _check_args(x, fw, stride)
    mode = block_mode(x, fw)
    lib = _build.library()
    B, H, W, cin = x.shape
    width, cout = block_dims(fw)
    Ho, Wo = _out_size(H, stride), _out_size(W, stride)
    mid = fw["w1"].dtype  # h1, h2: int8 in K2, bf16 in K1 and K10a
    h1 = torch.empty((B, H, W, width), dtype=mid, device=x.device)
    h2 = torch.empty((B, Ho, Wo, width), dtype=mid, device=x.device)
    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == "q":
            code = lib.mmb_bottleneck_s8(
                x.data_ptr(), *_ptrs(fw, _Q_ORDER), h1.data_ptr(),
                h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout,
                stride, stream)
        elif mode == "t":
            code = lib.mmb_bottleneck_t(
                x.data_ptr(), *_ptrs(fw, _T_ORDER), h1.data_ptr(),
                h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout,
                stride, stream)
        else:
            code = lib.mmb_bottleneck_bf16(
                x.data_ptr(), *_ptrs(fw, _BF16_ORDER), h1.data_ptr(),
                h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout,
                stride, stream)
    _build.check(lib, code, "fused_bottleneck")
    counter = {"bf16": "launches", "q": "launches_q", "t": "launches_t"}[mode]
    setattr(fused_bottleneck, counter, getattr(fused_bottleneck, counter) + 1)
    return out


# the weights in the order of the kernels' C interfaces
_BF16_ORDER = ("w1", "b1", "w2", "b2", "w3", "b3", "wd", "bd")
_Q_ORDER = ("w1", "a1", "b1", "w2", "a2", "b2", "w3", "a3", "b3", "wd", "ad",
            "bd", "ai")
_T_ORDER = ("w1", "b1", "w2", "b2", "w3", "a3", "b3", "wd", "ad", "bd", "ai")

fused_bottleneck.launches = 0
fused_bottleneck.launches_q = 0
fused_bottleneck.launches_t = 0


def default_band(W: int, cin: int, Ho: int, stride: int, Bc: int) -> int:
    """The TPU package's default band for ``fused_bottleneck_tiles``: the
    most output rows, dividing Ho, whose bf16 input tile stays under about
    3.3 MB."""
    cap = max(1, (3_300_000 // (Bc * W * cin * 2)) // stride)
    return next(h for h in range(min(Ho, cap), 0, -1) if Ho % h == 0)


def fused_bottleneck_tiles(x: torch.Tensor, fw: Folded, stride: int = 1,
                           Bc: int = 16, hh: int | None = None
                           ) -> torch.Tensor:
    """K10b: one bf16 block (K1's function) computed tile by tile, one
    launch per (chunk of ``Bc`` images, band of ``hh`` output rows), as the
    TPU package's ``fused_bottleneck_tiles`` calls its kernel once per tile
    of an XLA scan. Each launch reads its band's halo rows from the input
    (zero rows at the image border) and writes its band of the output.
    ``hh`` defaults to the TPU package's choice (``default_band``).

    On a CUDA tensor (bf16 x and weights, shapes as K1) it launches the
    kernel and raises on anything it cannot take; on a CPU tensor it runs
    ``tiles_reference``. ``fused_bottleneck_tiles.launches`` counts
    launches."""
    B, H, W, cin = x.shape
    Ho = _out_size(H, stride)
    if hh is None:
        hh = default_band(W, cin, Ho, stride, Bc)
    if Bc < 1 or B % Bc or hh < 1 or Ho % hh:
        raise ValueError(f"fused_bottleneck_tiles: Bc {Bc} must divide B "
                         f"{B} and hh {hh} the output rows {Ho}")
    if x.device.type == "cpu":
        return tiles_reference(x, fw, stride, Bc, hh)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_tiles: no kernel for device "
                         f"{x.device}")
    _check_args(x, fw, stride)
    if block_mode(x, fw) != "bf16":
        raise ValueError("fused_bottleneck_tiles: bf16 blocks only")
    lib = _build.library()
    width, cout = block_dims(fw)
    Wo = _out_size(W, stride)
    # scratch for one chunk, reused by every launch (one stream: in order)
    h1 = torch.empty((Bc, H, W, width), dtype=x.dtype, device=x.device)
    h2 = torch.empty((Bc, Ho, Wo, width), dtype=x.dtype, device=x.device)
    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    weights = _ptrs(fw, _BF16_ORDER)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, B, Bc):
            for lo in range(0, Ho, hh):
                code = lib.mmb_bottleneck_band_bf16(
                    x[b0].data_ptr(), *weights, h1.data_ptr(),
                    h2.data_ptr(), out[b0].data_ptr(), Bc, H, W, cin, width,
                    cout, stride, lo, hh, stream)
                _build.check(lib, code, "fused_bottleneck_tiles")
                fused_bottleneck_tiles.launches += 1
    return out


fused_bottleneck_tiles.launches = 0
