"""K10a (``fused_bottleneck``, ``fused_stage`` and ``fused_stage_banded`` on
int8-transport folds) on the transport tile, on the CPU: the tile's
arithmetic order emulated in plain PyTorch and held against the JAX
package's Pallas transport kernels (``fused_bottleneck_hwbc`` and
``fused_stage_hwbc`` on ``fold_block_params_t`` weights, interpret mode,
through ``to_hwbc``/``from_hwbc``, as tests/test_torch_transport.py runs
them) and the port's ``bottleneck_reference_t``; and the tile's launch
geometry (``ops/bottleneck.py::conv_geometry_t``, ``block_geometry_t``,
``stage_geometry_t``).

The tile's order (csrc/conv_gemm.cuh with the codes as an A operand,
csrc/conv_gemm_s8.cuh's conv3 walk and epilogue): conv1 as in-order k16
partial sums (16 products each) of the codes (integers in [0, 127], exact
in bf16) and the bf16 w1 into one f32 accumulator, the K tail of the
64-deep slices as zeros, then + b1 in f32, the ReLU, one rounding to bf16
h1; the grouped 3x3 on K1's halo tiles (their sums: the plain grouped
convolution in f32, as tests/test_torch_conv_tile.py takes them); conv3 as
in-order k16 sums over h2 into acc3 and, with a downsample, k16 sums over
x[:, ::s, ::s] into their own accumulator accd, then K2's epilogue
clip(rint((acc3 a3 + b3) + identity), 0, 127) with identity = accd ad + bd
or x ai, every product and sum rounded once, half to even. A stage is the
chain of its blocks (the stage kernel equals its K10a launches code for
code on the card). The emulation is a test helper; no model path calls it.

Gate: phase 2f's (chip_smoke.py::check_codes), at most 1 code apart and
fewer than 1e-3 of the codes differing, for a block; a stage's chain by
its cosine to the JAX stage kernel (>= 0.9999, a moved code rides the
residual path into the next block) and the same code envelope where the
two chains agree on every block's input. Observed at these shapes: the
emulated block equals bottleneck_reference_t code for code, and the
Pallas kernel but for 0 or 1 of 131,072 or 524,288 codes (one apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu_torch.ops import bottleneck as T
from multimodal_baby_tpu_torch.ops import quant as TQ
from multimodal_baby_tpu_torch.ops import stage as TS

from test_torch_conv_tile import gemm_k16, walk
from test_torch_quant import codes_close
from test_torch_transport import folds

COS_TOL = 0.9999


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread: beside the other test
    workers, torch's default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kernel_order_block_t(x, fw, stride):
    """K10a on NHWC int8 codes x in the transport tile's arithmetic
    order."""
    B, H, W, cin = x.shape
    bf16 = torch.bfloat16
    codes = x.float()  # the bf16 the tile converts them to, exactly
    h1 = torch.relu(gemm_k16([(codes.reshape(-1, cin), fw["w1"])])
                    + fw["b1"])
    h1 = h1.to(bf16).reshape(B, H, W, -1)
    h2 = T._grouped(h1, fw, stride, bf16)
    xs = codes[:, ::stride, ::stride].reshape(-1, cin)
    y = gemm_k16([(h2.reshape(-1, h2.shape[-1]), fw["w3"])]) * fw["a3"] \
        + fw["b3"]
    if "wd" in fw:
        identity = gemm_k16([(xs, fw["wd"])]) * fw["ad"] + fw["bd"]
    else:
        identity = xs * fw["ai"]
    out = torch.round(y + identity).clamp(0, 127).to(torch.int8)
    return out.reshape(*h2.shape[:3], -1)


def codes(rng, B, H, cin):
    return rng.randint(0, 100, (B, H, H, cin)).astype(np.int8)


@pytest.mark.parametrize("stride,has_ds,cin", [
    (1, False, 256),   # tests/test_quant_trunk.py:234
    (2, True, 256),
    (1, True, 64),     # layer 1's head: one 64-deep slice of codes
])
def test_kernel_order_matches_pallas_and_plain(stride, has_ds, cin):
    """The transport tile's order (``kernel_order_block_t``) meets phase
    2f's envelope against the Pallas transport kernel and
    ``bottleneck_reference_t`` at bf16 weights, with and without a
    downsample, at stride 1 and 2. This checks the order, not the kernel:
    the kernel is held to ``bottleneck_reference_t`` on the card
    (tests/test_torch_cuda.py, chip_smoke.py phase 2f)."""
    rng = np.random.RandomState(11 + stride + cin)
    fw, jfw = folds(rng, cin, has_ds, torch.bfloat16)
    x = codes(rng, 32, 8, cin)
    got = kernel_order_block_t(torch.from_numpy(x), fw, stride)
    Ho = (8 - 1) // stride + 1
    assert got.dtype == torch.int8 and got.shape == (32, Ho, Ho, 256)
    assert 0.05 < float((got > 0).float().mean()) < 1  # not all clipped
    codes_close(got, J.from_hwbc(J.fused_bottleneck_hwbc(
        J.to_hwbc(jnp.asarray(x), 32), jfw, stride=stride)))
    codes_close(got, TQ.bottleneck_reference_t(torch.from_numpy(x), fw,
                                               stride=stride))


def test_stage_chain_matches_pallas_stage_kernel():
    """A 3-block transport stage with a stride-2 head
    (tests/test_quant_trunk.py:255-292) as the chain of emulated blocks,
    against the Pallas stage kernel in interpret mode: cosine >= 0.9999,
    and each emulated block within the code envelope of the plain block on
    the same input."""
    rng = np.random.RandomState(12)
    strides = [2, 1, 1]
    pairs = [folds(rng, 256, j == 0, torch.bfloat16) for j in range(3)]
    x = codes(rng, 32, 8, 256)
    want = J.from_hwbc(J.fused_stage_hwbc(
        J.to_hwbc(jnp.asarray(x), 32), [j for _, j in pairs], strides))
    y = torch.from_numpy(x)
    for (fw, _), s in zip(pairs, strides):
        plain = TQ.bottleneck_reference_t(y, fw, stride=s)
        y = kernel_order_block_t(y, fw, s)
        codes_close(y, plain)
    a = y.double().flatten()
    b = torch.from_numpy(np.array(want)).double().flatten()
    assert float(a @ b / (a.norm() * b.norm())) >= COS_TOL


# the "t" plan's block shapes (chip_smoke.T_BLOCKS_224) and every other
# ResNeXt-50 block shape at B = 128, the "t,t,1,1" plan's layer-1 head, and
# the card tests' K10a shapes (tests/test_torch_cuda.py, B = 32): (B, H,
# cin, width, cout, stride, downsample)
T_BLOCK_SHAPES = sorted({
    *[(128, *s) for s in [
        (56, 64, 128, 256, 1, True), (56, 256, 128, 256, 1, False),
        (56, 256, 256, 512, 2, True), (28, 512, 256, 512, 1, False),
        (28, 512, 512, 1024, 2, True), (14, 1024, 512, 1024, 1, False),
        (14, 1024, 1024, 2048, 2, True), (7, 2048, 1024, 2048, 1, False)]],
    *[(32, *s) for s in [
        (8, 256, 128, 256, 1, False), (8, 256, 128, 256, 2, True),
        (8, 64, 128, 256, 1, True), (7, 512, 256, 512, 2, True),
        (5, 512, 256, 512, 1, False)]],
})


@pytest.mark.parametrize("blocks", [132, 114])
@pytest.mark.parametrize("B,H,cin,width,cout,stride,ds", T_BLOCK_SHAPES)
def test_geometry_serves_every_block_shape(B, H, cin, width, cout, stride,
                                           ds, blocks):
    """conv1 on 128-row tiles of 64-deep slices of the codes; conv3 on
    128-row tiles with the residual, 64-row ones with the downsample's own
    sums; every (row band, column tile) taken once."""
    conv1, conv3 = T.block_geometry_t(B, H, H, cin, width, cout, stride, ds,
                                      blocks)
    Ho = (H - 1) // stride + 1
    for d, M, N, K1, K2, rows in (
            (conv1, B * H * H, width, cin, 0, 128),
            (conv3, B * Ho * Ho, cout, width, cin if ds else 0,
             64 if ds else 128)):
        assert (d.rows, d.part, d.parts) == (rows, M, 1)
        assert d.bands == -(-M // rows) and d.columns == N // 128
        assert d.tiles == d.bands * d.columns
        assert d.grid == min(blocks, d.tiles)
        assert d.slices == -(-K1 // 64) + -(-K2 // 64)
        seen = [(band, col) for _, _, band, col in walk(d)]
        assert sorted(seen) == [(r, c) for r in range(d.bands)
                                for c in range(d.columns)]


# (H, cin, width, cout, strides, band): the "t" plan's stages
# (chip_smoke.T_STAGES_224) and the card tests' transport stages
T_STAGE_SHAPES = [
    (14, 1024, 512, 1024, [1] * 5, 14), (14, 1024, 1024, 2048, [2, 1, 1], 7),
    (56, 64, 128, 256, [1, 1, 1], 28), (8, 256, 128, 256, [2, 1, 1], 4),
    (14, 1024, 512, 1024, [1, 1, 1], 14), (8, 256, 128, 256, [1, 1, 1], 4),
    (16, 64, 128, 256, [1, 1, 1], 4)]


@pytest.mark.parametrize("H,cin,width,cout,strides,band", T_STAGE_SHAPES)
def test_stage_geometry_serves_every_stage_shape(H, cin, width, cout,
                                                 strides, band):
    """Every band and block of a transport stage on 64-row tiles: one
    store part of all rows where a band is the whole image, else one an
    image of the band's rows (the store never crosses an image)."""
    B = 128
    steps = T.stage_geometry_t(B, H, H, cin, width, cout, strides, band)
    Ho = H
    for s in strides:
        Ho = (Ho - 1) // s + 1
    assert len(steps) == Ho // band * len(strides)
    for conv1, conv3 in steps:
        for d in (conv1, conv3):
            assert d.rows == 64 and d.parts in (1, B)
            assert d.tiles == -(-d.part // 64) * d.parts * d.columns
        assert conv1.columns == width // 128 and conv3.columns == cout // 128
    first = steps[0][1]  # the head's conv3: the downsample where it has one
    has_ds = cin != cout or strides[0] != 1
    assert first.slices == -(-width // 64) + (-(-cin // 64) if has_ds else 0)


@pytest.mark.parametrize("part,K1,N,K2,rows", [
    (0, 64, 128, 0, None), (2**31, 64, 128, 0, None),
    (100, 48, 128, 0, None), (100, 64, 128, 16, None),
    (100, 64, 192, 0, None), (100, 64, 128, 64, 128),
    (100, 64, 128, 0, 32)])
def test_geometry_refuses_what_the_tile_cannot_serve(part, K1, N, K2, rows):
    """M < 1 or past int32 rows, K not a multiple of 32, N not of 128, a
    128-row tile with the downsample's own sums, a row count the tile has
    not."""
    with pytest.raises(ValueError):
        T.conv_geometry_t(part, K1, N, K2, rows=rows)


def test_geometry_takes_a_k_tail():
    """Cin = 96 (the wrapper's Cin % 32 == 0): two 64-deep slices of codes,
    the second's tail read as zeros."""
    assert T.conv_geometry_t(300, 96, 256).slices == 2
    assert T.conv_geometry_t(300, 128, 256, 96).slices == 4


@pytest.mark.parametrize("H,band,ok", [(128, 4, True), (136, 136, True),
                                       (136, 4, False), (136, 68, False)])
def test_banded_stage_needs_h_at_most_128(H, band, ok):
    """A banded transport stage reads its bands through TMA im2col maps,
    whose box corners lie in [-128, 127] rows: it refuses H > 128 unless
    its band is the whole image, as the bf16 and int8 bodies do."""
    rng = np.random.RandomState(13)
    fws = [folds(rng, cin, j == 0, torch.bfloat16)[0]
           for j, cin in enumerate((64, 256))]
    x = torch.zeros(32, H, H, 64, dtype=torch.int8)
    if ok:
        TS._check_stage(x, fws, [1, 1], band)
    else:
        with pytest.raises(ValueError, match="H <= 128"):
            TS._check_stage(x, fws, [1, 1], band)
