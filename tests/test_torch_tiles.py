"""K10b's plain version (``ops/bottleneck.py::fused_bottleneck_tiles`` on
CPU tensors, ``tiles_reference``) against the JAX package on the CPU.

The port computes the bf16 block (K1's function) tile by tile, one call per
(batch chunk, band of output rows), with the band's halo rows read from the
input and zero rows at the image border, as the JAX package's
``fused_bottleneck_tiles`` calls its Pallas kernel once per tile of an XLA
scan. Held against that function in interpret mode at
``tests/test_hwbc_kernels.py:70-80``'s shape and its tolerance (RTOL 5e-5,
max error relative to the largest output: f32 with another summation
order), and against the port's own ``bottleneck_reference`` on the whole
tensor at more band and chunk sizes, odd spatial sizes included (the same
f32 products; only the library's summation order over a slice of the rows
can differ). The CUDA kernel is held against this plain version and
against K1 on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu_torch.ops import bottleneck as TB

from test_torch_bottleneck import make_weights, rel_err

RTOL = 5e-5  # tests/test_hwbc_kernels.py:22


def test_tiles_match_jax_tiles_kernel():
    """tests/test_hwbc_kernels.py:70-80: B = 32, 16 x 16, Cin 128, width
    256, Cout 512, stride 2, Bc 16, hh 2 (R 2 on the TPU side)."""
    rng = np.random.RandomState(7)
    fw, jfw = make_weights(rng, 128, 256, 512, True)
    x = rng.randn(32, 16, 16, 128).astype(np.float32)
    want = J.from_hwbc(J.fused_bottleneck_tiles(
        J.to_hwbc(jnp.asarray(x)), jfw, stride=2, Bc=16, hh=2, R=2))
    before = TB.fused_bottleneck_tiles.launches
    got = TB.fused_bottleneck_tiles(torch.from_numpy(x), fw, stride=2,
                                    Bc=16, hh=2)
    assert TB.fused_bottleneck_tiles.launches == before  # plain on the CPU
    assert tuple(got.shape) == (32, 8, 8, 512)
    assert rel_err(got.numpy(), want) < RTOL


@pytest.mark.parametrize("stride,has_ds,B,H,cin,width,cout,Bc,hh", [
    (2, True, 32, 16, 128, 256, 512, 16, 2),
    (1, False, 8, 8, 256, 128, 256, 4, 1),       # one row per band
    (1, True, 4, 8, 64, 128, 256, 2, 4),
    (1, False, 4, 7, 256, 128, 256, 4, 7),       # odd size, one band
    (2, True, 4, 7, 64, 128, 256, 1, 2),         # odd size: 7 -> 4
    (2, True, 4, 9, 64, 128, 256, 4, 5),         # 9 -> 5: the last input
                                                 # row ends the image
])
def test_tiles_equal_the_whole_block(stride, has_ds, B, H, cin, width, cout,
                                     Bc, hh):
    rng = np.random.RandomState(H + cin + hh)
    fw, _ = make_weights(rng, cin, width, cout, has_ds)
    x = torch.from_numpy(rng.randn(B, H, H, cin).astype(np.float32))
    got = TB.fused_bottleneck_tiles(x, fw, stride=stride, Bc=Bc, hh=hh)
    want = TB.bottleneck_reference(x, fw, stride=stride)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want.numpy()) < RTOL


def test_tiles_default_band_is_the_jax_choice():
    """hh defaults to the JAX package's rule (bottleneck_hwbc.py:553-557):
    the most output rows, dividing Ho, whose tile stays under about 3.3
    MB of bf16 input (layer 2's head at Bc 16: 2 rows)."""
    assert TB.default_band(56, 256, 28, 2, 16) == 2
    assert TB.default_band(16, 128, 8, 2, 16) == 8
    rng = np.random.RandomState(2)
    fw, _ = make_weights(rng, 128, 256, 512, True)
    x = torch.from_numpy(rng.randn(16, 16, 16, 128).astype(np.float32))
    assert torch.equal(TB.fused_bottleneck_tiles(x, fw, 2),
                       TB.fused_bottleneck_tiles(x, fw, 2, 16, 8))


@pytest.mark.parametrize("Bc,hh", [(3, 2), (16, 3), (0, 2)])
def test_tiles_refuse_chunks_and_bands_that_do_not_tile(Bc, hh):
    rng = np.random.RandomState(3)
    fw, _ = make_weights(rng, 64, 128, 256, True)
    x = torch.zeros(16, 8, 8, 64)
    with pytest.raises(ValueError):
        TB.fused_bottleneck_tiles(x, fw, stride=2, Bc=Bc, hh=hh)
