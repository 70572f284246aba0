"""The fused ResNeXt bottleneck block (K1 in bf16, K2 in int8, K10a in int8
transport, K10b in one launch with h1 and h2 in shared memory) for the
PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/bottleneck_hwbc.py``: the
BatchNorm fold, the plain reference of one block, ``fused_bottleneck``,
which runs the hand-written Hopper kernels in ``csrc/bottleneck.cu`` on a
CUDA tensor and the plain reference on a CPU tensor (K1's 1x1
convolutions on the TMA-fed wgmma tile of ``csrc/conv_gemm.cuh``, whose
launch geometry ``conv_geometry`` states, K2's on its int8 sibling
``csrc/conv_gemm_s8.cuh``, ``conv_geometry_s8``, K10a's on the first with
the int8 codes as an A operand and the second's conv3 walk and epilogue,
``conv_geometry_t``), and
``fused_bottleneck_tiles`` (the TPU package's tile mode; its kernel is
``csrc/bottleneck_fused.cu``), and ``fused_bottleneck_diff``, which
differentiates ``fused_bottleneck`` through the plain reference. The int8
folds and plain versions are in ``ops/quant.py``.

Layout is NHWC ``[B, H, W, C]`` at the public functions. The TPU's
``[H, B/16, W, 16, C]`` layout and the block-diagonal packing of the
grouped 3x3 weight (``pack_grouped_kernel``, for the TPU's 128-wide matrix
unit) are not carried over: the grouped weight stays in its compact form
``[3, 3, cg, W]`` (tap row, tap column, input channel within the group,
output channel), with cg = W / 32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.vit_common import PlainVJP

__all__ = ["fold_block_params", "unpack_grouped_kernel", "bottleneck_reference",
           "block_reference", "tiles_reference", "fused_bottleneck",
           "fused_bottleneck_tiles", "fused_bottleneck_diff", "block_mode",
           "default_band",
           "tiles_geometry", "TilesGeometry", "conv_geometry",
           "block_geometry", "ConvGeometry", "conv_geometry_s8",
           "block_geometry_s8", "stage_geometry_s8", "ConvGeometryS8",
           "conv_geometry_t", "block_geometry_t", "stage_geometry_t",
           "band_rows", "BN_EPS", "GROUPS"]

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


# the 1x1 convolutions' tile (csrc/conv_gemm.cuh, CV_* and PP_*): a
# warpgroup's 128 x 128 output tile, 64-deep K slices; the kernel owns the
# rest of its launch (threads, ring, shared memory)
CONV_TILE_M, CONV_TILE_N, CONV_BK = 128, 128, 64
CONV_MAX_ROWS = 2**31 - CONV_TILE_M  # TMA coordinates are int32


class ConvGeometry(NamedTuple):
    """One GEMM [M, K1 (+ K2)] . [K1 (+ K2), N] on the 1x1 convolutions'
    tile as K1 launches it (its output rows contiguous): ``bands`` row
    bands of CONV_TILE_M rows and ``columns`` column tiles of CONV_TILE_N
    (``tiles`` of them, each a warpgroup's, walked in ``slices`` 64-deep K
    slices each: the segments' K tails read as zeros) by ``grid``
    persistent blocks, one an SM (the kernel computes the same grid from
    the card's SM count). A banded stage cuts its row bands within each
    image's band instead (csrc/conv_gemm.cuh)."""
    bands: int
    columns: int
    tiles: int
    slices: int
    grid: int


def conv_geometry(M: int, K1: int, N: int, K2: int = 0,
                  blocks: int = 132) -> ConvGeometry:
    """The launch geometry of one 1x1 convolution on the tile for M output
    pixels, K1 input channels (and K2 of a second segment, the downsample)
    and N output channels on a card of ``blocks`` SMs (132 on an H100
    SXM). Raises ValueError on a shape the tile cannot serve; never
    clamps."""
    if not 1 <= M <= CONV_MAX_ROWS:
        raise ValueError(f"conv_geometry: needs 1 <= M <= {CONV_MAX_ROWS}; "
                         f"got M={M}")
    if N < CONV_TILE_N or N % CONV_TILE_N:
        raise ValueError(f"conv_geometry: needs N a positive multiple of "
                         f"{CONV_TILE_N}; got N={N}")
    # TMA rows are whole 16-byte units: K a multiple of 8 bf16
    if K1 < 8 or K1 % 8 or K2 < 0 or K2 % 8:
        raise ValueError(f"conv_geometry: needs K1 and K2 multiples of 8, "
                         f"K1 positive; got K1={K1}, K2={K2}")
    if blocks < 1:
        raise ValueError(f"conv_geometry: needs at least one SM; got "
                         f"blocks={blocks}")
    bands = -(-M // CONV_TILE_M)
    columns = N // CONV_TILE_N
    slices = -(-K1 // CONV_BK) + -(-K2 // CONV_BK)
    return ConvGeometry(bands, columns, bands * columns, slices,
                        min(bands * columns, blocks))


def block_geometry(B: int, H: int, W: int, cin: int, width: int, cout: int,
                   stride: int, has_ds: bool, blocks: int = 132):
    """(conv1, conv3): K1's two launches on the tile for a bf16 block on
    [B, H, W, cin] (conv3 with the downsample as its second segment)."""
    Ho, Wo = _out_size(H, stride), _out_size(W, stride)
    return (conv_geometry(B * H * W, cin, width, 0, blocks),
            conv_geometry(B * Ho * Wo, width, cout, cin if has_ds else 0,
                          blocks))


# the int8 1x1 tile (csrc/conv_gemm_s8.cuh, C8_*): a warpgroup's 128 x 128
# output tile in K2, or 64 x 128 for a GEMM with a second K segment (the
# downsample, in its own sums) and in every GEMM of the stage kernel
# (S8_STAGE_ROWS), in K slices of 128 channels (a K tail reads as zeros)
CONV8_TILE_M, CONV8_TILE_M_TWO, CONV8_BK = 128, 64, 128
CONV8_STAGE_M = 64
CONV8_K_UNIT = 64  # the int8 block's Cin % 64 (_check_args)


class ConvGeometryS8(NamedTuple):
    """One int8 or transport GEMM on its tile: its output rows in ``parts``
    store parts of ``part`` rows each (one part of M rows for a block and
    K3a, one an image for a banded stage), cut into ``bands`` row bands of
    ``rows`` rows within each part, and ``columns`` column tiles of 128:
    ``tiles`` tiles (band-major within a part, then parts), each walked in
    ``slices`` K slices (128 deep on the int8 tile, 64 on the transport
    one), by ``grid`` persistent blocks, one an SM (the kernel computes the
    same grid from the card's SM count)."""
    rows: int
    part: int
    parts: int
    bands: int
    columns: int
    tiles: int
    slices: int
    grid: int


def _banded_geometry(name, part, K1, N, K2, blocks, parts, rows, bk,
                     k_unit) -> ConvGeometryS8:
    """conv_geometry_s8's and conv_geometry_t's checks and walk: tiles of
    ``rows`` rows (None: 64 with a second segment, else 128), K slices of
    ``bk``, K1 and K2 multiples of ``k_unit``."""
    if rows is None:
        rows = CONV8_TILE_M_TWO if K2 else CONV8_TILE_M
    if rows not in (CONV8_TILE_M_TWO, CONV8_TILE_M) or (
            K2 and rows != CONV8_TILE_M_TWO):
        raise ValueError(f"{name}: needs tiles of 64 rows, or of 128 "
                         f"without a second segment; got rows={rows}, "
                         f"K2={K2}")
    if parts < 1 or not 1 <= part <= (2**31 - rows) // parts:
        raise ValueError(f"{name}: needs parts >= 1 and 1 <= part x parts "
                         f"<= 2**31 - {rows} (TMA rows are int32); got "
                         f"part={part}, parts={parts}")
    if N < CONV_TILE_N or N % CONV_TILE_N:
        raise ValueError(f"{name}: needs N a positive multiple of "
                         f"{CONV_TILE_N}; got N={N}")
    if K1 < k_unit or K1 % k_unit or K2 < 0 or K2 % k_unit:
        raise ValueError(f"{name}: needs K1 and K2 multiples of {k_unit}, "
                         f"K1 positive; got K1={K1}, K2={K2}")
    if blocks < 1:
        raise ValueError(f"{name}: needs at least one SM; got "
                         f"blocks={blocks}")
    bands = -(-part // rows)
    columns = N // CONV_TILE_N
    tiles = bands * parts * columns
    slices = -(-K1 // bk) + -(-K2 // bk)
    return ConvGeometryS8(rows, part, parts, bands, columns, tiles, slices,
                          min(tiles, blocks))


def conv_geometry_s8(part: int, K1: int, N: int, K2: int = 0,
                     blocks: int = 132, parts: int = 1,
                     rows: int | None = None) -> ConvGeometryS8:
    """The launch geometry of one int8 1x1 convolution on the int8 tile:
    ``parts`` store parts of ``part`` output pixels, K1 input channels (and
    K2 of the downsample's segment) and N output channels on a card of
    ``blocks`` SMs, on tiles of ``rows`` rows (None: K2's, 64 with a second
    segment, else 128). Raises ValueError on a shape the tile cannot serve;
    never clamps."""
    return _banded_geometry("conv_geometry_s8", part, K1, N, K2, blocks,
                            parts, rows, CONV8_BK, CONV8_K_UNIT)


def block_geometry_s8(B: int, H: int, W: int, cin: int, width: int,
                      cout: int, stride: int, has_ds: bool,
                      blocks: int = 132):
    """(conv1, conv3): K2's two launches on the int8 tile for an int8 block
    on [B, H, W, cin] (conv3 with the downsample as its second segment)."""
    Ho, Wo = _out_size(H, stride), _out_size(W, stride)
    return (conv_geometry_s8(B * H * W, cin, width, 0, blocks),
            conv_geometry_s8(B * Ho * Wo, width, cout,
                             cin if has_ds else 0, blocks))


# the transport tile (K10a: csrc/conv_gemm.cuh's slices, 64 deep, with the
# int8 codes as conv1's and the downsample's A; conv3's walk and epilogue of
# csrc/conv_gemm_s8.cuh): K2's rows (128, 64 with the downsample's own
# sums, 64 everywhere in the stage kernel); K a multiple of 32, the
# wrapper's Cin % 32 (a 64-deep slice reads its tail as zeros; the codes'
# rows must be whole 16-byte units for the TMA)
CONVT_BK, CONVT_K_UNIT = CONV_BK, 32


def conv_geometry_t(part: int, K1: int, N: int, K2: int = 0,
                    blocks: int = 132, parts: int = 1,
                    rows: int | None = None) -> ConvGeometryS8:
    """The launch geometry of one of K10a's 1x1 convolutions on the
    transport tile: as ``conv_geometry_s8`` (its fields and refusals), in
    64-deep K slices with K1 and K2 multiples of 32."""
    return _banded_geometry("conv_geometry_t", part, K1, N, K2, blocks,
                            parts, rows, CONVT_BK, CONVT_K_UNIT)


def block_geometry_t(B: int, H: int, W: int, cin: int, width: int,
                     cout: int, stride: int, has_ds: bool,
                     blocks: int = 132):
    """(conv1, conv3): K10a's two launches on the transport tile for a
    block on [B, H, W, cin] codes (conv3 with the downsample's own sums as
    its second segment)."""
    Ho, Wo = _out_size(H, stride), _out_size(W, stride)
    return (conv_geometry_t(B * H * W, cin, width, 0, blocks),
            conv_geometry_t(B * Ho * Wo, width, cout, cin if has_ds else 0,
                            blocks))


def band_rows(H: int, strides, band: int, i: int, j: int):
    """The rows (in_lo, in_hi, out_lo, out_hi) of block j's input and output
    that band i of a stage's output (``band`` rows of every image) needs:
    the band widened by one row per stride-1 3x3 below it, doubled at a
    stride-2 block, clipped to the image (csrc/stage.cu::band_rows)."""
    heights = [H]  # each block's input height
    for s in strides:
        heights.append(_out_size(heights[-1], s))
    out_lo, out_hi = i * band, (i + 1) * band
    for k in range(len(strides) - 1, j - 1, -1):
        s = strides[k]
        in_lo = max(out_lo * s - 1, 0)
        in_hi = min((out_hi - 1) * s + 2, heights[k])
        if k == j:
            return in_lo, in_hi, out_lo, out_hi
        out_lo, out_hi = in_lo, in_hi
    raise ValueError(f"band_rows: no block {j} of {len(strides)}")


def stage_geometry_s8(B: int, H: int, W: int, cin: int, width: int,
                      cout: int, strides, band: int, blocks: int = 132,
                      conv=conv_geometry_s8):
    """[(conv1, conv3)] of every band and block of an int8 stage on the
    int8 tile's 64-row tiles (band = the output height: K3a, one band):
    each GEMM's rows one store part when its band is the whole image, else
    one part an image (csrc/conv_gemm.cuh::band_store_map). ``conv``: the
    tile's geometry (``conv_geometry_t`` for a transport stage)."""
    Ho = H
    for s in strides:
        Ho = _out_size(Ho, s)
    out = []
    for i in range(Ho // band):
        h, w, c = H, W, cin
        for j, s in enumerate(strides):
            in_lo, in_hi, out_lo, out_hi = band_rows(H, strides, band, i, j)
            ho, wo = _out_size(h, s), _out_size(w, s)
            ext1, ext3 = in_hi - in_lo, out_hi - out_lo
            p1 = (B * h * w, 1) if ext1 == h else (ext1 * w, B)
            p3 = (B * ho * wo, 1) if ext3 == ho else (ext3 * wo, B)
            ds = j == 0 and (c != cout or s != 1)
            out.append((conv(p1[0], c, width, 0, blocks, p1[1],
                             CONV8_STAGE_M),
                        conv(p3[0], width, cout, c if ds else 0, blocks,
                             p3[1], CONV8_STAGE_M)))
            h, w, c = ho, wo, cout
    return out


def stage_geometry_t(B: int, H: int, W: int, cin: int, width: int,
                     cout: int, strides, band: int, blocks: int = 132):
    """``stage_geometry_s8`` for a transport stage: every GEMM on the
    transport tile's 64-row tiles (the downsample's identity parked in
    shared memory)."""
    return stage_geometry_s8(B, H, W, cin, width, cout, strides, band,
                             blocks, conv_geometry_t)


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
    # the tiles refuse what they cannot serve
    geometry = {"bf16": block_geometry, "q": block_geometry_s8,
                "t": block_geometry_t}[mode]
    geometry(B, H, W, cin, width, cout, stride, "wd" in fw)
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


def _by_name(block):
    """``block(x, fw, stride=...)`` called as ``PlainVJP`` calls it: the
    weights as tensors, then their names and the stride."""
    def call(x, *args):
        *weights, names, stride = args
        return block(x, dict(zip(names, weights)), stride=stride)
    return call


def fused_bottleneck_diff(x: torch.Tensor, fw: Folded, stride: int = 1
                          ) -> torch.Tensor:
    """``fused_bottleneck`` with gradients for x and every folded weight
    (the JAX package's ``fused_bottleneck_hwbc_diff``): the forward is
    ``fused_bottleneck`` (K1 on a CUDA tensor, equal to it bit for bit),
    the backward the VJP of ``bottleneck_reference`` recomputed from the
    saved inputs. bf16 or f32 activations only: the int8 modes round, and
    have no gradient."""
    if x.dtype == torch.int8:
        raise ValueError("fused_bottleneck_diff: int8 codes have no gradient")
    names = tuple(fw)
    return PlainVJP.apply(_by_name(fused_bottleneck),
                          _by_name(bottleneck_reference), (names, stride), x,
                          *fw.values())


def default_band(W: int, cin: int, Ho: int, stride: int, Bc: int) -> int:
    """The TPU package's default band for ``fused_bottleneck_tiles``: the
    most output rows, dividing Ho, whose bf16 input tile stays under about
    3.3 MB."""
    cap = max(1, (3_300_000 // (Bc * W * cin * 2)) // stride)
    return next(h for h in range(min(Ho, cap), 0, -1) if Ho % h == 0)


# K10b's kernel (csrc/bottleneck_fused.cu, FB_*): GEMM passes of 64 rows x
# 256 columns (128 a warpgroup) fed by a 4-stage ring of 32-deep slices (an
# x slice [64][32] and a weight slice [32][256], bf16); at most 8 16-pixel
# tiles a band
FUSED_BM, FUSED_BN, FUSED_BK, FUSED_STAGES = 64, 256, 32, 4
FUSED_MAX_PIXELS = 128
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100


def fused_ring_bytes() -> int:
    """The bytes of one ring (conv1's and conv3's are alike)."""
    return FUSED_STAGES * (FUSED_BM * FUSED_BK + FUSED_BK * FUSED_BN) * 2


class TilesGeometry(NamedTuple):
    """K10b's launch for one block shape (``csrc/bottleneck_fused.cu``):
    bands of ``R`` output rows, ``tiles`` of them an image (the last may be
    shorter), each on an input window of ``rows_in`` = (R - 1) stride + 3
    rows (row 0 is input row R t stride - 1; rows outside the image are
    zeros); shared memory holds h1 ([rows_in][W + 2][width] bf16, zero
    columns each side) at 0, h2 (width / 32 blocks of [ceil(R Wo / 16)
    16][32]) at ``h2_off``, conv1's ring at ``ring1_off`` (over h2, not yet
    written) and conv3's at ``ring3_off`` (over h1 where it fits, h1 then
    being dead), w2's copy for the grouped 3x3 at ``w2_off`` (after h2,
    where the block's shared memory can hold it; -1: w2 is read in place);
    ``smem`` bytes in all, with 1 KB of slack to align the
    base (the swizzle atoms need 1 KB alignment; the offsets are multiples
    of 1 KB). ``R`` and the fields after ``tiles`` are the kernel's launch
    arguments, in order."""
    R: int
    tiles: int
    rows_in: int
    h2_off: int
    ring1_off: int
    ring3_off: int
    w2_off: int
    smem: int


def _fused_layout(R, W, width, stride):
    """(rows_in, h1 bytes rounded to 1 KB, ring3 offset, smem) of bands of R
    output rows: offsets 1 KB aligned for the swizzle atoms, and 1 KB of
    slack to align the base. conv3 reads h2 64 rows at a time: past its
    last column block it reads up to 63 rows (4 KB) of what follows, which
    must be shared memory of the block."""
    def align(n):
        return -(-n // 1024) * 1024

    ring = fused_ring_bytes()
    M = R * _out_size(W, stride)
    rows_in = (R - 1) * stride + 3
    h1 = align(rows_in * (W + 2) * width * 2)
    h2 = -(-M // 16) * 16 * width * 2
    over = (-(-M // 64) * 64 - -(-M // 16) * 16) * 64
    end = max(h1 + ring, h1 + h2 + over)
    if ring <= h1:
        return rows_in, h1, 0, end + 1024
    at = h1 + align(h2)
    return rows_in, h1, at, max(end, at + ring) + 1024


def tiles_geometry(H: int, W: int, cin: int, width: int, cout: int,
                   stride: int, has_ds: bool) -> TilesGeometry:
    """K10b's band geometry for a block on [*, H, W, cin]: among the band
    heights R whose shared memory fits and whose band has at most 128
    output pixels, the one with the least tensor work, counted in the
    kernel's padded passes (64 rows, 256 columns) over conv1's window and
    conv3's band (ties: the larger R, fewer weight reads). Raises
    ValueError on a shape the kernel cannot serve; never clamps."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"tiles_geometry: {msg}")

    need(stride in (1, 2), f"stride must be 1 or 2, got {stride}")
    need(cin % FUSED_BK == 0 and width in (128, 256, 512, 1024)
         and cout % 128 == 0 and H >= 1 and W >= 1,
         f"needs Cin % {FUSED_BK} == 0, W in (128, 256, 512, 1024), Cout % "
         f"128 == 0; got H={H}, W={W}, Cin={cin}, width={width}, "
         f"Cout={cout}")
    Ho, Wo = _out_size(H, stride), _out_size(W, stride)

    def passes(n, size):
        return -(-n // size) * size

    best = None
    for R in range(1, min(Ho, FUSED_MAX_PIXELS // Wo) + 1):
        rows_in, h1, ring3, smem = _fused_layout(R, W, width, stride)
        if smem > SMEM_LIMIT:
            break  # grows with R
        tiles = -(-Ho // R)
        work = tiles * (
            passes(rows_in * W, FUSED_BM) * cin * passes(width, FUSED_BN)
            + passes(R * Wo, FUSED_BM) * (width + (cin if has_ds else 0))
            * passes(cout, FUSED_BN))
        w2_off = h1 + -(-R * Wo // 16) * 16 * width * 2  # after h2
        w2_end = w2_off + 9 * width ** 2 // 16
        if w2_end + 1024 <= SMEM_LIMIT:
            smem = max(smem, w2_end + 1024)
        else:
            w2_off = -1
        if best is None or work <= best[0]:
            best = (work, TilesGeometry(R, tiles, rows_in, h1, h1, ring3,
                                        w2_off, smem))
    need(best is not None,
         f"no band fits {SMEM_LIMIT} bytes of shared memory with at most "
         f"{FUSED_MAX_PIXELS} output pixels: H={H}, W={W}, width={width}")
    return best[1]


def fused_bottleneck_tiles(x: torch.Tensor, fw: Folded, stride: int = 1,
                           Bc: int = 16, hh: int | None = None
                           ) -> torch.Tensor:
    """K10b: one bf16 block (K1's function) in the TPU package's tile mode.
    ``Bc`` (images a chunk) and ``hh`` (output rows a band; default the TPU
    package's choice, ``default_band``) are the JAX API's and are checked
    as it checks them; the plain version computes tile by tile with them.
    The kernel takes its own tiles (``tiles_geometry``): ONE launch a call,
    a block per (image, band), h1 and h2 in shared memory.

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
    width, cout = block_dims(fw)
    geo = tiles_geometry(H, W, cin, width, cout, stride, "wd" in fw)
    lib = _build.library()
    out = torch.empty((B, Ho, _out_size(W, stride), cout), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        code = lib.mmb_bottleneck_fused_bf16(
            x.data_ptr(), *_ptrs(fw, _BF16_ORDER), out.data_ptr(), B, H, W,
            cin, width, cout, stride, geo.R, *geo[2:],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_bottleneck_tiles")
    fused_bottleneck_tiles.launches += 1
    return out


fused_bottleneck_tiles.launches = 0
