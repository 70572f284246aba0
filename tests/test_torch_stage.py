"""The port's whole-stage module (``ops/stage.py``, K3a and K3b) against the
JAX package on the CPU.

The stage's plain version, ``stage_reference``, is held against the Pallas
kernels ``fused_stage_hwbc`` (K3a; f32 and int8) and ``fused_stage_banded``
(K3b; f32) in interpret mode, at the shapes of
``tests/test_hwbc_kernels.py:90-121`` and ``tests/test_quant_trunk.py:100``:
f32 within that file's RTOL (5e-5 of the largest output: f32 with other
summation orders), int8 in the quantized envelope (at most 1 code apart,
fewer than 1e-3 differing). The CUDA kernel is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu.ops import quant as JQ
from multimodal_baby_tpu_torch.ops import stage as TS
from multimodal_baby_tpu_torch.ops.bottleneck import unpack_grouped_kernel

from test_torch_bottleneck import _random_block_state, make_weights, rel_err
from test_torch_quant import AMAX, codes_close

RTOL = 5e-5


def f32_stage(rng, cin, strides, width=128, cout=256):
    """Folded f32 blocks for the port and for JAX (packed w2)."""
    tfws, jfws = [], []
    c = cin
    for i, _ in enumerate(strides):
        t, j = make_weights(rng, c, width, cout, i == 0)
        tfws.append(t)
        jfws.append(j)
        c = cout
    return tfws, jfws


def to_jax(x):
    return J.to_hwbc(jnp.asarray(x))


@pytest.mark.parametrize("H,cin,strides", [
    (12, 256, [2, 1, 1]),   # stride-2 head + chain (layer3/4 shape)
    (8, 128, [1, 1]),       # stride-1 head with downsample
])
def test_reference_matches_full_stage_kernel(H, cin, strides):
    rng = np.random.RandomState(3)
    tfws, jfws = f32_stage(rng, cin, strides)
    x = rng.randn(32, H, H, cin).astype(np.float32)
    got = TS.stage_reference(torch.from_numpy(x), tfws, strides)
    want = J.from_hwbc(J.fused_stage_hwbc(to_jax(x), jfws, strides, Bc=16))
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < RTOL


@pytest.mark.parametrize("H,cin,strides,hh,R", [
    (16, 64, [1, 1, 1], 4, 4),    # banded layer1 shape, 4 bands
    (16, 128, [2, 1, 1], 4, 4),   # banded with stride-2 head (layer2)
    (16, 64, [1, 1, 1], 16, 8),   # one band = whole stage
])
def test_reference_matches_banded_stage_kernel(H, cin, strides, hh, R):
    rng = np.random.RandomState(4)
    tfws, jfws = f32_stage(rng, cin, strides)
    x = rng.randn(32, H, H, cin).astype(np.float32)
    got = TS.fused_stage_banded(torch.from_numpy(x), tfws, strides, hh)
    want = J.from_hwbc(J.fused_stage_banded(to_jax(x), jfws, strides, Bc=16,
                                            hh=hh, R=R))
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < RTOL


def q_stage(rng, cin=256, n=3, planes=64):
    """JAX int8 folds of a stage at tests/test_quant_trunk.py's shapes, and
    the same weights in the port's layout (compact w2). The chain is held
    on one set of weights: the two folds agree to an ulp of rsqrt
    (tests/test_torch_quant.py), and an ulp in a scale, moving a rounding
    in an early block, carries through the later ones."""
    tfws, jfws = [], []
    c = cin
    for j in range(n):
        _, params, stats = _random_block_state(rng, c, 2 * planes,
                                               4 * planes, j == 0)
        jfw = JQ.fold_block_params_q(
            params, stats, **{k: jnp.float32(v) for k, v in AMAX.items()})
        tfw = {k: torch.from_numpy(np.array(v)) for k, v in jfw.items()}
        tfw["w2"] = unpack_grouped_kernel(tfw["w2"], 2 * planes // 32)
        for k in ("w1", "w3", "wd"):  # the port's are output-major
            if k in tfw:
                tfw[k] = tfw[k].t().contiguous()
        tfws.append(tfw)
        jfws.append(jfw)
        c = 4 * planes
    return tfws, jfws


@pytest.mark.parametrize("cin,strides", [
    (256, [2, 1, 1]),  # tests/test_quant_trunk.py:100: stride-2 head
    (64, [1, 1, 1]),   # Cin = 64: half of the int8 tile's 128-deep slice
])
def test_reference_matches_int8_stage_kernel(cin, strides):
    """A 3-block int8 stage: the port's plain version against the Pallas
    kernel in interpret mode and the JAX plain chain, in the quantized
    envelope (at most 1 code apart, fewer than 1e-3 differing; both sum
    exactly and round half to even, so 0 codes are expected)."""
    rng = np.random.RandomState(2)
    tfws, jfws = q_stage(rng, cin=cin)
    x = rng.randint(0, 100, (32, 8, 8, cin)).astype(np.int8)
    got = TS.fused_stage(torch.from_numpy(x), tfws, strides)
    assert got.dtype == torch.int8
    codes_close(got, J.from_hwbc(J.fused_stage_hwbc(
        J.to_hwbc(jnp.asarray(x), 32), jfws, strides)))
    codes_close(got, J.from_hwbc(J.stage_reference(
        J.to_hwbc(jnp.asarray(x), 32), jfws, strides)))


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    rng = np.random.RandomState(5)
    tfws, _ = f32_stage(rng, 64, [1, 1])
    x = torch.from_numpy(rng.randn(2, 8, 8, 64).astype(np.float32))
    before = (TS.fused_stage.launches, TS.fused_stage_banded.launches)
    want = TS.stage_reference(x, tfws, [1, 1])
    assert torch.equal(TS.fused_stage(x, tfws, [1, 1]), want)
    assert torch.equal(TS.fused_stage_banded(x, tfws, [1, 1], 4), want)
    assert (TS.fused_stage.launches,
            TS.fused_stage_banded.launches) == before


@pytest.mark.parametrize("bad", ["ok", "band", "stride", "too_many",
                                 "width", "dtype"])
def test_stage_argument_checks(bad):
    """What the CUDA path checks before it launches: a band that divides
    the output rows, a stride only in the first block, at most 6 blocks of
    one width, and each block as the per-block kernels take it."""
    rng = np.random.RandomState(6)
    n = 7 if bad == "too_many" else 3
    tfws, _ = f32_stage(rng, 64, [1] * n)
    fws = [{k: (v if k[0] == "b" else v.to(torch.bfloat16))
            for k, v in fw.items()} for fw in tfws]
    strides = [1] * n
    band = 4
    x = torch.zeros(2, 8, 8, 64, dtype=torch.bfloat16)
    if bad == "band":
        band = 3
    elif bad == "stride":
        strides[1] = 2
    elif bad == "width":
        fws[2] = make_weights(rng, 256, 256, 256, False)[0]
    elif bad == "dtype":
        x = x.float()
    if bad == "ok":
        TS._check_stage(x, fws, strides, band)
    else:
        with pytest.raises(ValueError):
            TS._check_stage(x, fws, strides, band)
