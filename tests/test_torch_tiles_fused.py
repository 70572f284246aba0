"""K10b's one-launch kernel (``csrc/bottleneck_fused.cu``) on the CPU: its
band geometry (``ops/bottleneck.py::tiles_geometry``) at every ResNeXt-50
block shape and at the card tests' shapes, and a torch emulation of the
kernel's tile walk in f32 held against the plain version and the JAX
package.

The emulation walks the tiles as the kernel does: a block per (image, band
of R output rows); h1 on the band's input window of (rows - 1) stride + 3
rows, zero rows outside the image and a zero column each side; conv1 in
passes of 64 window pixels x 256 channels over 32-deep slices; the grouped
3x3 tap by tap on h1's tap-shifted pixels; conv3 with the downsample as
extra depth in passes of 64 output pixels x 256 channels; every output row
written by exactly one band. Held to ``tiles_reference`` and to the JAX
``fused_bottleneck_tiles`` in interpret mode within RTOL 5e-5 (f32 with
other summation orders, ``tests/test_hwbc_kernels.py:22``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu_torch.ops import bottleneck as TB

from test_torch_bottleneck import make_weights, rel_err

RTOL = 5e-5  # tests/test_hwbc_kernels.py:22

# (H, Cin, width, Cout, stride, downsample): the 8 ResNeXt-50 block shapes
# at 224 px, the card tests' (tests/test_torch_cuda.py) and chip_smoke.py's
BLOCK_SHAPES = [
    (56, 64, 128, 256, 1, True), (56, 256, 128, 256, 1, False),
    (56, 256, 256, 512, 2, True), (28, 512, 256, 512, 1, False),
    (28, 512, 512, 1024, 2, True), (14, 1024, 512, 1024, 1, False),
    (14, 1024, 1024, 2048, 2, True), (7, 2048, 1024, 2048, 1, False),
    (16, 128, 256, 512, 2, True), (8, 256, 128, 256, 1, False),
    (7, 64, 128, 256, 1, True), (9, 64, 128, 256, 2, True),
]


@pytest.mark.parametrize("H,cin,width,cout,stride,has_ds", BLOCK_SHAPES)
def test_tiles_geometry_fits_and_covers_every_row(H, cin, width, cout,
                                                  stride, has_ds):
    geo = TB.tiles_geometry(H, H, cin, width, cout, stride, has_ds)
    Ho = (H - 1) // stride + 1
    M = geo.R * Ho
    h1 = -(-geo.rows_in * (H + 2) * width * 2 // 1024) * 1024
    h2 = -(-M // 16) * 16 * width * 2
    over = (-(-M // 64) * 64 - -(-M // 16) * 16) * 64  # conv3's 64-row reads
    ring1 = ring3 = TB.fused_ring_bytes()
    assert geo.rows_in == (geo.R - 1) * stride + 3
    assert geo.smem <= TB.SMEM_LIMIT
    assert M <= TB.FUSED_MAX_PIXELS
    # the bands cover the output rows once: the last one is not empty
    assert (geo.tiles - 1) * geo.R < Ho <= geo.tiles * geo.R
    # h1 at 0, h2 after it; conv1's ring over h2, conv3's over h1 or after
    # h2; offsets 1 KB aligned, and 1 KB of slack to align the base
    assert geo.h2_off == geo.ring1_off == h1
    assert all(v % 1024 == 0 for v in geo[3:6])
    assert geo.ring1_off + ring1 + 1024 <= geo.smem
    assert geo.h2_off + h2 + over + 1024 <= geo.smem
    if geo.w2_off >= 0:  # w2's copy, written after h2 in the grouped 3x3
        assert geo.w2_off % 16 == 0 and geo.w2_off >= geo.h2_off + h2
        assert geo.w2_off + 9 * width * width // 16 + 1024 <= geo.smem
    else:
        assert width >= 512
    if geo.ring3_off == 0:
        assert ring3 <= h1
    else:
        assert geo.ring3_off >= geo.h2_off + h2
        assert geo.ring3_off + ring3 + 1024 <= geo.smem


def test_tiles_geometry_at_layer2_head():
    """The shape chip_smoke.py times: 2-row bands on a 5 x 58 window,
    231,424 bytes, conv3's ring over h1, w2 copied after h2."""
    assert TB.tiles_geometry(56, 56, 256, 256, 512, 2, True) == \
        TB.TilesGeometry(2, 14, 5, 148480, 148480, 0, 181248, 231424)


@pytest.mark.parametrize("args", [
    (56, 56, 48, 256, 512, 2, True),     # Cin not a multiple of 32
    (56, 56, 256, 192, 512, 2, True),    # width
    (56, 56, 256, 256, 200, 2, True),    # Cout
    (56, 56, 256, 256, 512, 3, True),    # stride
    (8, 200, 256, 1024, 512, 1, True),   # no band fits shared memory
    (8, 300, 64, 128, 256, 1, True),     # a row has more than 128 pixels
])
def test_tiles_geometry_refuses(args):
    with pytest.raises(ValueError):
        TB.tiles_geometry(*args)


def emulate_kernel(x, fw, stride):
    """The kernel's tile walk in f32 (see the module docstring)."""
    f32 = torch.float32
    B, H, W, cin = x.shape
    width, cout = TB.block_dims(fw)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    has_ds = "wd" in fw
    geo = TB.tiles_geometry(H, W, cin, width, cout, stride, has_ds)
    cg = width // 32
    w = {k: v.to(f32) for k, v in fw.items()}
    out = torch.full((B, Ho, Wo, cout), float("nan"))
    written = torch.zeros(B, Ho, dtype=torch.int64)

    def gemm(a, bw, rows, cols):
        """a [rows, K] . bw [K, cols] in passes of 64 x 256 over 32-deep
        slices."""
        acc = torch.zeros(rows, cols)
        bm, bn, bk = TB.FUSED_BM, TB.FUSED_BN, TB.FUSED_BK
        for m0 in range(0, rows, bm):
            for n0 in range(0, cols, bn):
                for k0 in range(0, a.shape[1], bk):
                    acc[m0:m0 + bm, n0:n0 + bn] += (
                        a[m0:m0 + bm, k0:k0 + bk] @ bw[k0:k0 + bk, n0:n0 + bn])
        return acc

    for b in range(B):
        for t in range(geo.tiles):
            ro0 = t * geo.R
            rows_out = min(geo.R, Ho - ro0)
            rows_eff = (rows_out - 1) * stride + 3
            assert rows_eff <= geo.rows_in
            ri = torch.arange(ro0 * stride - 1, ro0 * stride - 1 + rows_eff)
            inside = (ri >= 0) & (ri < H)
            # phase 1: h1 on the window, zero rows outside the image
            a = torch.zeros(rows_eff, W, cin)
            a[inside] = x[b, ri[inside]].to(f32)
            h = torch.relu(gemm(a.reshape(-1, cin), w["w1"], rows_eff * W,
                                width) + w["b1"]).to(x.dtype).to(f32)
            h = h.reshape(rows_eff, W, width) * inside[:, None, None]
            h1 = torch.zeros(geo.rows_in, W + 2, width)
            h1[:rows_eff, 1:W + 1] = h
            # phase 2: the grouped 3x3, tap by tap on shifted pixels
            M = rows_out * Wo
            m = torch.arange(M)
            orow, ocol = m // Wo, m % Wo
            acc = torch.zeros(M, width)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                patch = h1[orow * stride + dy, ocol * stride + dx]
                acc += torch.einsum(
                    "mgi,igo->mgo", patch.reshape(M, 32, cg),
                    w["w2"][dy, dx].reshape(cg, 32, cg)).reshape(M, width)
            h2 = torch.relu(acc + w["b2"]).to(x.dtype).to(f32)
            # phase 3: conv3 with the downsample as extra depth
            xs = x[b, (ro0 + orow) * stride, ocol * stride].to(f32)
            if has_ds:
                y = gemm(torch.cat([h2, xs], 1),
                         torch.cat([w["w3"], w["wd"]]), M, cout)
                y = y + w["b3"] + w["bd"]
            else:
                y = gemm(h2, w["w3"], M, cout) + w["b3"] + xs
            out[b, ro0 + orow, ocol] = torch.relu(y).to(x.dtype).to(f32)
            written[b, ro0:ro0 + rows_out] += 1
    assert bool((written == 1).all())
    return out.to(x.dtype)


@pytest.mark.parametrize("stride,has_ds,B,H,cin,width,cout", [
    (2, True, 2, 30, 64, 128, 256),     # 15 x 15 out: two bands, 8 + 7
    (1, False, 2, 21, 256, 128, 256),   # stride 1: bands 6, 6, 6, 3
    (1, True, 1, 7, 64, 128, 256),      # odd size, one band
    (2, True, 2, 9, 64, 128, 256),      # 9 -> 5: the last window row is
                                        # past the image
    (2, True, 1, 14, 64, 1024, 256),    # 32 channels a group
])
def test_tile_walk_equals_the_plain_version(stride, has_ds, B, H, cin, width,
                                            cout):
    rng = np.random.RandomState(H + cin + width)
    fw, _ = make_weights(rng, cin, width, cout, has_ds)
    x = torch.from_numpy(rng.randn(B, H, H, cin).astype(np.float32))
    got = emulate_kernel(x, fw, stride)
    Ho = (H - 1) // stride + 1
    want = TB.tiles_reference(x, fw, stride, 1, Ho)
    assert rel_err(got.numpy(), want.numpy()) < RTOL


def test_tile_walk_matches_jax_tiles_kernel():
    """tests/test_hwbc_kernels.py:70-80's shape: B = 32, 16 x 16, Cin 128,
    width 256, Cout 512, stride 2 (the JAX kernel with Bc 16, hh 2)."""
    rng = np.random.RandomState(7)
    fw, jfw = make_weights(rng, 128, 256, 512, True)
    x = rng.randn(32, 16, 16, 128).astype(np.float32)
    want = J.from_hwbc(J.fused_bottleneck_tiles(
        J.to_hwbc(jnp.asarray(x)), jfw, stride=2, Bc=16, hh=2, R=2))
    got = emulate_kernel(torch.from_numpy(x), fw, 2)
    assert rel_err(got.numpy(), want) < RTOL
