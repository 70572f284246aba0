"""K1 (``fused_bottleneck`` in bf16) and the bf16 stage kernel (K3a, K3b) on
the 1x1 convolutions' tile (csrc/conv_gemm.cuh), on the CPU: the tile's
arithmetic order emulated in plain PyTorch and held against the JAX
package's Pallas ``fused_bottleneck_hwbc`` (interpret mode, through
``to_hwbc``/``from_hwbc``, as tests/test_torch_bottleneck.py runs it) and
the port's ``bottleneck_reference``; and the tile's launch geometry
(``ops/bottleneck.py::conv_geometry``, ``block_geometry``).

The tile's order: conv1 as in-order k16 partial sums (16 products each)
into one f32 accumulator, the K tail of the 64-deep slices as zeros, then
+ b1 in f32, the ReLU, one rounding to bf16; the grouped 3x3 with the
sums of the earlier tile (bottleneck.cuh's halo tile sums the taps in
order as gconv_bf16_tile does: here the plain grouped convolution in f32);
conv3 as in-order k16 sums over h2 then, with a downsample, over x[:, ::s,
::s] into the same accumulator, then + b3, + bd (downsample) or + x, the
ReLU, one rounding. The emulation is a test helper; no model path calls
it.

Gate: phase 2's (chip_smoke.py), max error relative to the largest output
<= 1e-2 and cosine >= 0.9999. Observed at these shapes (bf16, B = 32):
against the Pallas kernel rel at most 1.4e-3 (12 to 33 of 262,144 or
524,288 outputs differ), against bottleneck_reference at most 2.7e-3 (1
to 32 differ), the cosine 0.9999999990 or more: a margin of 3.7x on the
relative error.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu_torch.ops import bottleneck as T

REL_TOL = 1e-2
COS_TOL = 0.9999
BATCH = 32  # the Pallas kernel's bf16 batch lanes: a multiple of 16

SHAPES = [  # tests/test_torch_bottleneck.py (test_hwbc_kernels.py's)
    (1, False, 8, 256, 128, 256, 4, 2),
    (1, True, 8, 64, 128, 256, 8, 4),
    (2, True, 8, 256, 256, 512, 4, 2),
    (2, True, 16, 64, 128, 256, 4, 2),
]


def gemm_k16(segments):
    """The sum over segments [(a [M, K], w [K, N]), ...] as in-order k16
    partial sums into one f32 accumulator (bf16 operands, products exact
    in f32), each segment zero-padded to its 64-deep slices."""
    acc = None
    for a, w in segments:
        pad = -a.shape[1] % T.CONV_BK
        a = torch.nn.functional.pad(a.float(), (0, pad))
        w = torch.nn.functional.pad(w.float(), (0, 0, 0, pad))
        for k in range(0, a.shape[1], 16):
            part = a[:, k:k + 16] @ w[k:k + 16]
            acc = part if acc is None else acc + part
    return acc


def kernel_order_block(x, fw, stride):
    """K1 on bf16 NHWC x in the tile's arithmetic order."""
    B, H, W, cin = x.shape
    bf16 = torch.bfloat16
    h1 = torch.relu(gemm_k16([(x.reshape(-1, cin), fw["w1"])]) + fw["b1"])
    h1 = h1.to(bf16).reshape(B, H, W, -1)
    h2 = T._grouped(h1, fw, stride, bf16)
    xs = x[:, ::stride, ::stride].reshape(-1, cin)
    segments = [(h2.reshape(-1, h2.shape[-1]), fw["w3"])]
    if "wd" in fw:
        segments.append((xs, fw["wd"]))
    v = gemm_k16(segments) + fw["b3"]
    v = v + fw["bd"] if "wd" in fw else v + xs.float()
    return torch.relu(v).to(bf16).reshape(*h2.shape[:3], -1)


def make_inputs(stride, has_ds, H, cin, width, cout, seed):
    """bf16 x and folded weights (bf16, f32 biases) for both packages, from
    numpy."""
    rng = np.random.RandomState(seed)
    cg = width // 32
    arrs = {"w1": rng.randn(cin, width) * .05, "b1": rng.randn(width) * .1,
            "w2": rng.randn(3, 3, cg, width) * .05,
            "b2": rng.randn(width) * .1, "w3": rng.randn(width, cout) * .05,
            "b3": rng.randn(cout) * .1}
    if has_ds:
        arrs.update(wd=rng.randn(cin, cout) * .05, bd=rng.randn(cout) * .1)
    x = np.maximum(rng.randn(BATCH, H, H, cin), 0).astype(np.float32)
    tfw = {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrs.items()}
    tfw = {k: v if k[0] == "b" else v.to(torch.bfloat16)
           for k, v in tfw.items()}
    jfw = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.float32 if k[0] == "b" else jnp.bfloat16) for k, v in tfw.items()}
    jfw["w2"] = J.pack_grouped_kernel(jfw["w2"], 32)
    return torch.from_numpy(x).to(torch.bfloat16), tfw, jfw


def assert_gate(got, want):
    got, want = got.double().flatten(), want.double().flatten()
    rel = float((got - want).abs().max() / want.abs().max())
    cos = float(got @ want / (got.norm() * want.norm()))
    assert rel <= REL_TOL and cos >= COS_TOL, (rel, cos)


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout,hh,R", SHAPES)
def test_kernel_order_matches_pallas_and_plain(stride, has_ds, H, cin, width,
                                               cout, hh, R):
    """The tile's arithmetic order (``kernel_order_block``) meets phase 2's
    gate against the Pallas kernel and ``bottleneck_reference``, with and
    without a downsample, at stride 1 and 2. This checks the order, not the
    kernel: the kernel itself is held to ``bottleneck_reference`` on the
    card (tests/test_torch_cuda.py, chip_smoke.py phase 2) and to K10b bit
    for bit (phase 2f)."""
    x, tfw, jfw = make_inputs(stride, has_ds, H, cin, width, cout,
                              H + cin + stride)
    got = kernel_order_block(x, tfw, stride)
    Ho = (H - 1) // stride + 1
    assert got.dtype == torch.bfloat16 and got.shape == (BATCH, Ho, Ho, cout)
    want = J.from_hwbc(J.fused_bottleneck_hwbc(
        J.to_hwbc(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)), jfw,
        stride=stride, Bc=16, hh=hh, R=R))
    assert_gate(got.float(), torch.from_numpy(
        np.array(want.astype(jnp.float32))))
    assert_gate(got.float(), T.bottleneck_reference(x, tfw, stride=stride))


def walk(d):
    """The ping-pong walk of a GEMM's geometry: (block, warpgroup, row
    band, column tile) for every tile each block's warpgroups take (block b
    takes tiles b, b + grid, ..., its warpgroups in turns)."""
    out = []
    for blk in range(d.grid):
        for j, u in enumerate(range(blk, d.tiles, d.grid)):
            out.append((blk, j % 2, u // d.columns, u % d.columns))
    return out


# (B, H, cin, width, cout, stride, downsample): every ResNeXt-50 block shape
# of chip_smoke.py (BLOCKS_224 at B = 128, BLOCKS_EDGE at B = 8) and every
# K1 shape of the card tests (tests/test_torch_cuda.py, B = 2 and 32)
BLOCK_SHAPES = sorted({
    *[(128, *s) for s in [
        (56, 64, 128, 256, 1, True), (56, 256, 128, 256, 1, False),
        (56, 256, 256, 512, 2, True), (28, 512, 256, 512, 1, False),
        (28, 512, 512, 1024, 2, True), (14, 1024, 512, 1024, 1, False),
        (14, 1024, 1024, 2048, 2, True), (7, 2048, 1024, 2048, 1, False)]],
    *[(8, *s) for s in [
        (4, 1024, 1024, 2048, 2, True), (2, 2048, 1024, 2048, 1, False),
        (7, 512, 256, 512, 2, True), (5, 256, 128, 256, 1, False)]],
    *[(32, *s) for s in [
        (8, 256, 128, 256, 1, False), (8, 64, 128, 256, 1, True),
        (8, 256, 256, 512, 2, True), (16, 64, 128, 256, 2, True),
        (7, 512, 256, 512, 2, True), (2, 2048, 1024, 2048, 1, False)]],
    *[(2, *s) for s in [
        (56, 64, 128, 256, 1, True), (56, 256, 128, 256, 1, False),
        (56, 256, 256, 512, 2, True), (28, 512, 256, 512, 1, False),
        (28, 512, 512, 1024, 2, True), (14, 1024, 512, 1024, 1, False),
        (14, 1024, 1024, 2048, 2, True), (7, 2048, 1024, 2048, 1, False),
        (9, 64, 128, 256, 2, True), (7, 64, 128, 256, 1, True)]],
})


# the SMs of an H100 SXM and of an H100 PCIe
@pytest.mark.parametrize("blocks", [132, 114])
@pytest.mark.parametrize("B,H,cin,width,cout,stride,ds", BLOCK_SHAPES)
def test_geometry_serves_every_block_shape(B, H, cin, width, cout, stride,
                                           ds, blocks):
    conv1, conv3 = T.block_geometry(B, H, H, cin, width, cout, stride, ds,
                                    blocks)
    Ho = (H - 1) // stride + 1
    for d, M, N, K in ((conv1, B * H * H, width, cin),
                       (conv3, B * Ho * Ho, cout,
                        width + (cin if ds else 0))):
        assert d.bands == -(-M // 128) and d.columns == N // 128
        assert d.tiles == d.bands * d.columns
        assert d.grid == min(blocks, d.tiles)
        assert d.slices * 64 >= K and d.slices <= -(-K // 64) + 1
        seen = [(band, col) for _, _, band, col in walk(d)]
        assert sorted(seen) == [(r, c) for r in range(d.bands)
                                for c in range(d.columns)]


def test_geometry_of_layer_1_and_layer_4():
    """B = 128 on 132 SMs: layer 1.0's conv1 takes 3136 one-slice tiles (K
    = 64), layer 4.0's conv3 784 tiles of 32 slices (width 1024 then the
    downsample's 1024); every block takes 23 or 24, or 5 or 6, the two
    warpgroups in turns."""
    c1, _ = T.block_geometry(128, 56, 56, 64, 128, 256, 1, True)
    _, c3 = T.block_geometry(128, 14, 14, 1024, 1024, 2048, 2, True)
    assert (c1.tiles, c1.slices, c3.tiles, c3.slices) == (3136, 1, 784, 32)
    for d, lo in ((c1, 23), (c3, 5)):
        per = np.bincount([blk for blk, *_ in walk(d)], minlength=d.grid)
        assert set(per) == {lo, lo + 1}
        turns = [wg for blk, wg, *_ in walk(d) if blk == 0]
        assert turns == [j % 2 for j in range(len(turns))]


@pytest.mark.parametrize("M,K1,N,K2,blocks", [
    (0, 64, 128, 0, 132), (-3, 64, 128, 0, 132), (2**31, 64, 128, 0, 132),
    (2**31 - 127, 64, 128, 0, 132), (100, 64, 0, 0, 132),
    (100, 64, 192, 0, 132), (100, 0, 128, 0, 132), (100, 60, 128, 0, 132),
    (100, 64, 128, 12, 132), (100, 64, 128, -8, 132), (100, 64, 128, 0, 0)])
def test_geometry_refuses_what_the_tile_cannot_serve(M, K1, N, K2, blocks):
    with pytest.raises(ValueError):
        T.conv_geometry(M, K1, N, K2, blocks)


def test_geometry_takes_a_k_tail():
    """K1 = 96 and K2 = 32 (the wrapper takes Cin % 32 == 0): two slices and
    one, the tails read as zeros."""
    assert T.conv_geometry(300, 96, 256, 32).slices == 3
