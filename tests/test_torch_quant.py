"""The port's int8 quantization (``ops/quant.py``) and K2's plain version
against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages. The quantizers
and the fold give equal int8 codes; their f32 vectors agree to 1e-6 of
each vector's largest element (the same f32 formulas, but rsqrt may differ
by an ulp, and the bias fold, beta - mean * mul, cancels in its small
elements). K2's plain version,
``bottleneck_reference_q``, is held against JAX's
``bottleneck_reference_q`` and against the Pallas kernel
``fused_bottleneck_hwbc`` in interpret mode (through ``to_hwbc(x, 32)``),
at ``tests/test_quant_trunk.py``'s shapes, in that test's envelope: at
most 1 code apart and fewer than 1e-3 of the codes differing (the dots are
exact on both sides; only the f32 epilogue can move a rounding). The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu.ops import quant as JQ
from multimodal_baby_tpu_torch.ops import bottleneck as TB
from multimodal_baby_tpu_torch.ops import quant as TQ

from test_torch_bottleneck import _random_block_state

VEC_RTOL = 1e-6
AMAX = dict(in_amax=2.0, h1_amax=1.5, h2_amax=1.5, out_amax=2.5)


def codes_close(got, want):
    """tests/test_quant_trunk.py's envelope: |diff| <= 1, < 1e-3 differ."""
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
        diff.max(), (diff > 0).mean())


def folds(rng, cin, width, cout, has_ds):
    """(port fold, JAX fold) of one random block at test_quant_trunk's
    amax values."""
    sd, params, stats = _random_block_state(rng, cin, width, cout, has_ds)
    fw = TQ.fold_block_params_q(sd, **AMAX)
    jfw = JQ.fold_block_params_q(
        params, stats, **{k: jnp.float32(v) for k, v in AMAX.items()})
    return fw, jfw


@pytest.mark.parametrize("shape,axis", [((16, 8), -1), ((3, 3, 4, 128), -1),
                                        ((64, 256), 0)])
def test_quantize_weight_matches_jax(shape, axis):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, scale = TQ.quantize_weight(torch.from_numpy(w), axis)
    want, jscale = JQ.quantize_weight(jnp.asarray(w), axis)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=0)


def test_quantize_activation_matches_jax():
    """Including exact .5 ties (round half to even) and the clip at 0/127."""
    rng = np.random.RandomState(1)
    amax = np.float32(2.54)
    s = np.float32(amax / 127)
    x = np.concatenate([rng.randn(4000) * 1.5,
                        (np.arange(-2, 130) + 0.5) * s]).astype(np.float32)
    got = TQ.quantize_activation(torch.from_numpy(x), float(amax))
    want = JQ.quantize_activation(jnp.asarray(x), jnp.float32(amax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() == 0 and got.max() == 127


def test_bn_bound_and_resolve_match_jax():
    rng = np.random.RandomState(2)
    w = (1 + .3 * rng.randn(64)).astype(np.float32)
    b = (.2 * rng.randn(64)).astype(np.float32)
    bn = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    np.testing.assert_allclose(float(TQ.bn_amax_bound(tw, tb)),
                               float(JQ.bn_amax_bound(bn)), rtol=0)
    for cal in (0.0, 3.25):
        np.testing.assert_allclose(
            float(TQ.resolve_amax(torch.tensor(cal), tw, tb)),
            float(JQ.resolve_amax(jnp.float32(cal), bn)), rtol=0)


@pytest.mark.parametrize("has_ds", [False, True])
def test_fold_q_matches_jax(has_ds):
    rng = np.random.RandomState(3)
    cin, width, cout = (64, 128, 256) if has_ds else (256, 128, 256)
    fw, jfw = folds(rng, cin, width, cout, has_ds)
    assert sorted(fw) == sorted(jfw)
    for k, got in fw.items():
        want = np.asarray(jfw[k])
        if k == "w2":
            want = TB.unpack_grouped_kernel(torch.from_numpy(np.array(want)),
                                            width // 32).numpy()
        elif k in ("w1", "w3", "wd"):  # the port's are output-major
            want = want.T
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        else:
            assert got.dtype == torch.float32, k
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=VEC_RTOL * np.abs(want).max(), err_msg=k)


SHAPES = [  # tests/test_quant_trunk.py (planes 64: width 128, Cout 256)
    (1, False, 256), (2, True, 256), (1, True, 64),
]


@pytest.mark.parametrize("stride,has_ds,cin", SHAPES)
def test_reference_q_matches_jax_oracle_and_pallas(stride, has_ds, cin):
    rng = np.random.RandomState(4)
    fw, jfw = folds(rng, cin, 128, 256, has_ds)
    x = rng.randint(0, 100, (32, 8, 8, cin)).astype(np.int8)
    got = TQ.bottleneck_reference_q(torch.from_numpy(x), fw, stride=stride)
    assert got.dtype == torch.int8
    codes_close(got, JQ.bottleneck_reference_q(jnp.asarray(x), jfw,
                                               stride=stride))
    codes_close(got, J.from_hwbc(J.fused_bottleneck_hwbc(
        J.to_hwbc(jnp.asarray(x), 32), jfw, stride=stride)))
    assert 0.05 < float((got > 0).float().mean()) < 1  # not all clipped


@pytest.mark.parametrize("H,stride", [(7, 2), (5, 1)])
def test_reference_q_small_and_odd_sizes(H, stride):
    """Odd sizes against a composition of the quantizers on float64 torch
    convolutions (exact on integer codes): stride 2 takes rows and columns
    0, 2, 4, ... with pad 1."""
    rng = np.random.RandomState(5)
    has_ds = stride != 1
    fw, _ = folds(rng, 256, 128, 256, has_ds)
    x = torch.from_numpy(rng.randint(0, 127, (2, H, H, 256)).astype(np.int8))
    got = TQ.bottleneck_reference_q(x, fw, stride=stride)
    F = torch.nn.functional
    xc = x.double().permute(0, 3, 1, 2)

    def rq(acc, a, b):
        return torch.round(acc.float() * a[:, None, None] + b[:, None, None]
                           ).clamp(0, 127)

    h1 = rq(F.conv2d(xc, fw["w1"].double()[:, :, None, None]), fw["a1"],
            fw["b1"])
    h2 = rq(F.conv2d(h1.double(), fw["w2"].double().permute(3, 2, 0, 1),
                     stride=stride, padding=1, groups=32), fw["a2"], fw["b2"])
    y = (F.conv2d(h2.double(), fw["w3"].double()[:, :, None, None])
         .float() * fw["a3"][:, None, None] + fw["b3"][:, None, None])
    if has_ds:
        idt = (F.conv2d(xc, fw["wd"].double()[:, :, None, None],
                        stride=stride).float() * fw["ad"][:, None, None]
               + fw["bd"][:, None, None])
    else:
        idt = xc.float() * fw["ai"][:, None, None]
    want = torch.round(y + idt).clamp(0, 127).permute(0, 2, 3, 1)
    ho = (H - 1) // stride + 1
    assert tuple(got.shape) == (2, ho, ho, 256)
    codes_close(got, want)


def test_wrapper_dispatches_int8_to_the_plain_version_on_cpu():
    rng = np.random.RandomState(6)
    fw, _ = folds(rng, 256, 128, 256, True)
    x = torch.from_numpy(rng.randint(0, 100, (2, 4, 4, 256)).astype(np.int8))
    before = (TB.fused_bottleneck.launches, TB.fused_bottleneck.launches_q)
    got = TB.fused_bottleneck(x, fw, stride=2)
    assert (TB.fused_bottleneck.launches,
            TB.fused_bottleneck.launches_q) == before
    assert torch.equal(got, TQ.bottleneck_reference_q(x, fw, stride=2))


@pytest.mark.parametrize("bad", ["ok", "bf16_weights", "no_ai", "cin",
                                 "scale_dtype"])
def test_int8_argument_checks(bad):
    """What the CUDA path checks before it launches K2: int8 codes with int8
    weights and f32 scales, ``ai`` exactly when there is no downsample,
    Cin a multiple of the int8 K tile (64)."""
    rng = np.random.RandomState(7)
    cin = 96 if bad == "cin" else 256
    fw, _ = folds(rng, cin, 128, cin, False)
    x = torch.zeros(2, 4, 4, cin, dtype=torch.int8)
    if bad == "bf16_weights":
        fw["w1"] = fw["w1"].to(torch.bfloat16)
    elif bad == "no_ai":
        del fw["ai"]
    elif bad == "scale_dtype":
        fw["a2"] = fw["a2"].double()
    if bad == "ok":
        TB._check_args(x, fw, 1)
    else:
        with pytest.raises(ValueError):
            TB._check_args(x, fw, 1)
