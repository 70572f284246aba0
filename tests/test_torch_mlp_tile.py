"""K6 (``fused_mlp``, csrc/vit.cu on csrc/vit_pingpong.cuh's ping-pong
tile) on the CPU: the kernel's arithmetic order emulated in plain PyTorch
and held against the JAX package's Pallas ``fused_mlp`` (interpret mode,
as tests/test_torch_vit_ops.py runs it) and the port's ``mlp_reference``;
and the kernel's launch geometry (``ops/vit_mlp.py::mlp_geometry``).

The kernel's order: LayerNorm rounded to bf16; fc1 as in-order k16 partial
sums (16 products each) into one f32 accumulator, the bf16 bias added in
f32, the GELU in f32 and the hidden rounded to bf16; fc2 the same way, then
(x + sum) + b2 in f32, rounded once. The emulation is a test helper; no
model path calls it.

Gate: phase 2b's (chip_smoke.py), max error relative to the largest output
<= 1e-2 and cosine >= 0.9999. Observed (C = 256, F = 512, M = 20, 257 and
400, every GELU form): against the Pallas kernel rel at most 2.9e-3 (its
rational erf and its sums' order move up to 203 of 102,400 bf16 outputs
by one rounding), against mlp_reference at most 1.8e-3 (up to 108 of
65,792), the cosine 1.0000000 to seven digits in every case: a margin of
3.5x on the relative error.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops.vit_mlp import fused_mlp as j_mlp
from multimodal_baby_tpu_torch.ops.vit_common import (
    GELU_MODES, gelu, layer_norm)
from multimodal_baby_tpu_torch.ops.vit_mlp import mlp_geometry, mlp_reference

C, F = 256, 512
EPS = 1e-6
REL_TOL = 1e-2
COS_TOL = 0.9999
# (B, N): M = B N = 20, 257 and 400 token rows, each ragged in the tile's
# 128-row bands
SHAPES = [(2, 10), (1, 257), (2, 200)]


def dense_k16(a, w):
    """a [M, K] . w [K, N] as in-order k16 partial sums into one f32
    accumulator (bf16 operands, products exact in f32)."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16].float() @ w[k:k + 16].float()
    return acc


def kernel_order_mlp(x, g, b, w1, b1, w2, b2, eps, gelu_mode):
    """K6 on bf16 x [B, N, C] in the kernel's arithmetic order."""
    B, N, _ = x.shape
    xn = layer_norm(x, g, b, eps).reshape(B * N, -1)
    h = gelu(dense_k16(xn, w1) + b1.float(), gelu_mode).to(torch.bfloat16)
    y = dense_k16(h, w2)
    out = (x.reshape(B * N, -1).float() + y) + b2.float()
    return out.to(torch.bfloat16).reshape(x.shape)


def make_inputs(B, N, seed):
    """bf16 numpy-seeded x and the half's parameters (LayerNorm scale and
    bias, w1 [C, F], b1, w2 [F, C], b2), as tests/test_torch_vit_ops.py."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, N, C), 1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C),
            rng.randn(C, F) / np.sqrt(C), 0.1 * rng.randn(F),
            rng.randn(F, C) / np.sqrt(F), 0.1 * rng.randn(C)]
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in arrs]


def run_jax(ts, gelu_mode):
    x, *params = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in ts]
    out = j_mlp(x, *params, EPS, gelu_mode)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def assert_gate(got, want):
    got, want = got.double().flatten(), want.double().flatten()
    rel = float((got - want).abs().max() / want.abs().max())
    cos = float(got @ want / (got.norm() * want.norm()))
    assert rel <= REL_TOL and cos >= COS_TOL, (rel, cos)


@pytest.mark.parametrize("gelu_mode", GELU_MODES)
@pytest.mark.parametrize("B,N", SHAPES)
def test_kernel_order_matches_pallas_and_plain(B, N, gelu_mode):
    """The arithmetic order chosen for the kernel (``kernel_order_mlp``)
    meets phase 2b's gate against the Pallas kernel and ``mlp_reference``.
    This checks the order, not the kernel: the kernel itself is held to
    ``mlp_reference`` on the card (tests/test_torch_cuda.py,
    chip_smoke.py phase 2b) and to K7 bit for bit (phase 2d)."""
    ts = make_inputs(B, N, B * 1000 + N)
    got = kernel_order_mlp(*ts, EPS, gelu_mode)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, C)
    assert_gate(got, run_jax(ts, gelu_mode))
    assert_gate(got, mlp_reference(*ts, EPS, gelu_mode))


def walk(d):
    """The ping-pong walk of a Dense's geometry: (block, warpgroup, row
    band, column tile) for every tile each block's warpgroups take (block b
    takes tiles b, b + grid, ..., its warpgroups in turns)."""
    out = []
    for blk in range(d.grid):
        for j, u in enumerate(range(blk, d.tiles, d.grid)):
            out.append((blk, j % 2, u // d.columns, u % d.columns))
    return out


# every (M, C, F) of the card tests (tests/test_torch_cuda.py: K6 alone and
# inside K7) and of chip_smoke.py (phases 2b, 2d, 4 and 6)
CARD_SHAPES = sorted({
    (B * N, c, f) for B, N, c, f in [
        (2, 10, 256, 1024), (2, 17, 256, 512), (4, 257, 768, 3072),
        (2, 257, 768, 3072), (3, 400, 768, 3072), (1, 752, 768, 3072),
        (1, 5, 256, 512), (2, 400, 256, 1024), (1, 752, 256, 512),
        (2, 17, 256, 1024), (2, 400, 768, 3072), (2, 752, 768, 3072),
        (128, 257, 768, 3072)]})


# the SMs of an H100 SXM and of an H100 PCIe
@pytest.mark.parametrize("blocks", [132, 114])
@pytest.mark.parametrize("M,C_,F_", CARD_SHAPES)
def test_geometry_serves_every_card_shape(M, C_, F_, blocks):
    geo = mlp_geometry(M, C_, F_, blocks)
    for d, N in ((geo.fc1, F_), (geo.fc2, C_)):
        assert d.bands == -(-M // 128) and d.columns == N // 128
        assert d.tiles == d.bands * d.columns
        assert d.grid == min(blocks, d.tiles)
        seen = [(band, col) for _, _, band, col in walk(d)]
        assert sorted(seen) == [(r, c) for r in range(d.bands)
                                for c in range(d.columns)]


def test_geometry_of_the_vit_slice():
    """ViT-B/14 at B = 128 on 132 SMs: every block takes 46 or 47 fc1
    tiles and 11 or 12 fc2 tiles, the two warpgroups in turns."""
    geo = mlp_geometry(128 * 257, 768, 3072)
    assert (geo.fc1.tiles, geo.fc2.tiles, geo.fc1.grid) == (6168, 1542, 132)
    for d, lo in ((geo.fc1, 46), (geo.fc2, 11)):
        per = np.bincount([blk for blk, *_ in walk(d)], minlength=d.grid)
        assert set(per) == {lo, lo + 1}
        turns = [wg for blk, wg, *_ in walk(d) if blk == 0]
        assert turns == [j % 2 for j in range(len(turns))]


@pytest.mark.parametrize("M,C_,F_,blocks", [
    (0, 256, 512, 132), (-5, 256, 512, 132), (2**31 - 127, 256, 512, 132),
    (2**31, 256, 512, 132),
    (20, 200, 512, 132), (20, 256, 3000, 132), (20, 0, 512, 132),
    (20, 256, 64, 132), (20, 256, 512, 0)])
def test_geometry_refuses_what_the_kernel_cannot_serve(M, C_, F_, blocks):
    with pytest.raises(ValueError):
        mlp_geometry(M, C_, F_, blocks)
