"""K2 and the int8 stage body on the int8 1x1 convolutions' tile
(csrc/conv_gemm_s8.cuh), on the CPU: the tile's launch geometry
(``ops/bottleneck.py::conv_geometry_s8``, ``block_geometry_s8``,
``stage_geometry_s8``, ``band_rows``), which the wrappers check before
they launch and the kernel's walk follows.

The walk: a GEMM's output rows lie in store parts (one part of all M rows
for K2 and K3a, one part an image for a banded stage); each part is cut
into row bands of 128 rows (64 for a GEMM with the downsample's second
segment, and for every GEMM of the stage kernel), and tile u is column
tile u % columns of row band u / columns % bands of part u / columns /
bands; block b of the persistent grid takes
tiles b, b + grid, ..., its two consumer warpgroups in turns. Every output
tile must be taken exactly once, and no tile may start past its part's end
(a TMA store at a negative coordinate is an illegal instruction: the
tile's rows past the end are clipped instead). The kernels themselves are
held against their plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2c).
"""

import pytest

from multimodal_baby_tpu_torch.ops import bottleneck as T


def walk(d):
    """(block, warpgroup, part, row band, column tile) of every tile of a
    geometry, as the kernel's walk takes them."""
    out = []
    for blk in range(d.grid):
        for j, u in enumerate(range(blk, d.tiles, d.grid)):
            band, col = divmod(u, d.columns)
            part, band = divmod(band, d.bands)
            out.append((blk, j % 2, part, band, col))
    return out


def assert_walk_covers(d):
    """Every (part, band, column) tile exactly once, every tile starting
    inside its part, and the bands covering each part's rows."""
    seen = sorted((part, band, col) for _, _, part, band, col in walk(d))
    assert seen == [(p, b, c) for p in range(d.parts) for b in range(d.bands)
                    for c in range(d.columns)]
    assert (d.bands - 1) * d.rows < d.part <= d.bands * d.rows
    assert d.grid == min(d.tiles, d.grid) and d.tiles == (
        d.bands * d.parts * d.columns)


# (B, H, cin, width, cout, stride, downsample): the int8 blocks of the
# published plan at B = 128 (chip_smoke.Q_BLOCKS_224), K2's card tests
# (tests/test_torch_cuda.py, B = 32 and 2) and chip_smoke's edge cases
INT8_BLOCKS = sorted({
    *[(128, *s) for s in [
        (28, 512, 512, 1024, 2, True), (14, 1024, 512, 1024, 1, False),
        (14, 1024, 1024, 2048, 2, True), (7, 2048, 1024, 2048, 1, False)]],
    *[(32, *s) for s in [
        (8, 256, 128, 256, 1, False), (8, 256, 128, 256, 2, True),
        (8, 64, 128, 256, 1, True), (7, 512, 512, 1024, 2, True),
        (5, 1024, 512, 1024, 1, False), (2, 2048, 1024, 2048, 1, False),
        (14, 1024, 512, 1024, 1, False), (14, 1024, 1024, 2048, 2, True),
        (28, 512, 512, 1024, 2, True)]],
    *[(2, *s) for s in [
        (9, 512, 512, 1024, 2, True), (7, 1024, 512, 1024, 1, False),
        (7, 2048, 1024, 2048, 1, False)]],
})


# the SMs of an H100 SXM and of an H100 PCIe
@pytest.mark.parametrize("blocks", [132, 114])
@pytest.mark.parametrize("B,H,cin,width,cout,stride,ds", INT8_BLOCKS)
def test_walk_covers_every_int8_block_shape(B, H, cin, width, cout, stride,
                                            ds, blocks):
    conv1, conv3 = T.block_geometry_s8(B, H, H, cin, width, cout, stride, ds,
                                       blocks)
    Ho = (H - 1) // stride + 1
    for d, M, N, K1, K2 in ((conv1, B * H * H, width, cin, 0),
                            (conv3, B * Ho * Ho, cout, width,
                             cin if ds else 0)):
        assert (d.part, d.parts, d.columns) == (M, 1, N // 128)
        assert d.rows == (64 if K2 else 128)
        assert d.slices == -(-K1 // 128) + -(-K2 // 128)
        assert d.grid == min(blocks, d.tiles)
        assert_walk_covers(d)


# (B, H, cin, width, cout, strides, band): K3a's int8 stages of the
# published plan (layer 3's tail, layer 4), the int8 stages of the card
# tests and chip_smoke (the banded one in two bands of 8 rows, a stride-2
# head at a ragged row count)
INT8_STAGES = [
    (128, 14, 1024, 512, 1024, [1] * 5, 14),
    (128, 14, 1024, 1024, 2048, [2, 1, 1], 7),
    (32, 8, 256, 128, 256, [2, 1, 1], 4),
    (32, 14, 1024, 512, 1024, [1] * 5, 14),
    (32, 16, 64, 128, 256, [1, 1, 1], 8),
    (2, 9, 512, 512, 1024, [2, 1], 5),
]


@pytest.mark.parametrize("blocks", [132, 114])
@pytest.mark.parametrize("B,H,cin,width,cout,strides,band", INT8_STAGES)
def test_walk_covers_every_int8_stage_shape(B, H, cin, width, cout, strides,
                                            band, blocks):
    steps = T.stage_geometry_s8(B, H, H, cin, width, cout, strides, band,
                                blocks)
    Ho = H
    for s in strides:
        Ho = (Ho - 1) // s + 1
    assert len(steps) == Ho // band * len(strides)
    for conv1, conv3 in steps:
        for d in (conv1, conv3):
            assert_walk_covers(d)
            assert d.rows == 64  # the stage kernel's tiles
            # a banded GEMM stores one part an image, a whole one one part
            assert d.parts in (1, B)


@pytest.mark.parametrize("H,strides,band", [
    (14, [1] * 5, 14), (14, [2, 1, 1], 7), (16, [1, 1, 1], 8),
    (16, [2, 1, 1], 4), (56, [1, 1, 1], 28)])
def test_band_rows_cover_each_block_and_hold_the_halo(H, strides, band):
    """Each band's rows of every block: the band's output rows, widened by
    one row each side per 3x3 below them (doubled through a stride-2
    block), clipped to the image; the bands' output rows of each block
    cover it, and one band is the whole image (K3a: no halo)."""
    heights = [H]
    for s in strides:
        heights.append((heights[-1] - 1) // s + 1)
    n_bands = heights[-1] // band
    for j, s in enumerate(strides):
        outs = set()
        for i in range(n_bands):
            in_lo, in_hi, out_lo, out_hi = T.band_rows(H, strides, band, i, j)
            assert in_lo == max(out_lo * s - 1, 0)
            assert in_hi == min((out_hi - 1) * s + 2, heights[j])
            outs.update(range(out_lo, out_hi))
        assert outs == set(range(heights[j + 1]))
    whole = T.band_rows(H, strides, heights[-1], 0, 0)
    assert whole == (0, H, 0, heights[1])


@pytest.mark.parametrize("part,K1,N,K2,blocks,parts", [
    (0, 128, 128, 0, 132, 1),           # no rows
    (-5, 128, 128, 0, 132, 1),
    (2**31 - 127, 128, 128, 0, 132, 1),  # past TMA's int32 rows
    (2**31 - 63, 128, 128, 64, 132, 1),
    (2**30, 128, 128, 0, 132, 2),        # the parts together past them
    (100, 96, 128, 0, 132, 1),           # K % 64
    (100, 32, 128, 0, 132, 1),
    (100, 128, 128, 96, 132, 1),
    (100, 128, 192, 0, 132, 1),          # N % 128
    (100, 128, 0, 0, 132, 1),
    (100, 128, 128, 0, 0, 1),            # no SM
    (100, 128, 128, 0, 132, 0),          # no part
])
def test_geometry_refuses_what_the_int8_tile_cannot_serve(part, K1, N, K2,
                                                          blocks, parts):
    with pytest.raises(ValueError):
        T.conv_geometry_s8(part, K1, N, K2, blocks, parts)


@pytest.mark.parametrize("rows,K2", [(128, 64), (96, 0), (32, 0)])
def test_geometry_refuses_tiles_it_has_not(rows, K2):
    """128-row tiles hold one set of sums (no second segment), and the
    tile has no other heights than 64 and 128."""
    with pytest.raises(ValueError):
        T.conv_geometry_s8(300, 128, 256, K2, rows=rows)


def test_geometry_takes_a_k_tail_and_the_downsample_tiles():
    """Cin = 64 reads half a 128-deep slice (its tail as zeros); a GEMM
    with the downsample's segment takes 64-row tiles (two accumulator sets
    of 64 a thread); the largest part TMA's rows take is served."""
    d = T.conv_geometry_s8(300, 64, 256)
    assert (d.slices, d.rows, d.bands) == (1, 128, 3)
    d = T.conv_geometry_s8(300, 512, 1024, 64)
    assert (d.slices, d.rows, d.bands) == (5, 64, 5)
    assert T.conv_geometry_s8(2**31 - 128, 128, 128).bands == 2**24 - 1
