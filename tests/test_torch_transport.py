"""The port's int8-transport mode (K10a's plain versions, the "t" and
"t,t,1,1" trunks) against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages. The fold
(``fold_block_params_t``) gives the JAX package's weights and vectors (the
grouped weight compared after unpacking); the block and stage plain
versions are held against JAX's oracle ``bottleneck_reference_t`` and its
Pallas kernels in interpret mode at ``tests/test_quant_trunk.py``'s
transport shapes (B = 32, 8 x 8, Cin 256, planes 64), in that test's
envelope: at most 1 code apart and fewer than 1e-3 of the codes differing
(f32 products in other orders can move a rounding of the output). At f32
weights the port's plain version, which rounds h1 and h2 to the weights'
dtype, is the JAX oracle's computation. The whole transport trunks are
held against JAX's in ``tests/test_torch_transport_trunk.py``; the plan
dispatch, the amax buffers, the bridge and the batch rule under the
transport plans are in ``tests/test_torch_int8_trunk.py``; the CUDA
kernels against these plain versions in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu.ops import quant as JQ
from multimodal_baby_tpu_torch.ops import bottleneck as TB
from multimodal_baby_tpu_torch.ops import quant as TQ
from multimodal_baby_tpu_torch.ops import stage as TS

from test_torch_bottleneck import _random_block_state
from test_torch_quant import VEC_RTOL, codes_close

AMAX_T = dict(in_amax=2.0, out_amax=2.5)  # tests/test_quant_trunk.py:228
B, H, CIN, WIDTH, COUT = 32, 8, 256, 128, 256  # planes 64


def folds(rng, cin, has_ds, dtype=torch.float32):
    """(port fold, JAX fold) of one random block at test_quant_trunk's
    transport amax values, in ``dtype``."""
    sd, params, stats = _random_block_state(rng, cin, WIDTH, COUT, has_ds)
    fw = TQ.fold_block_params_t(sd, **AMAX_T, compute_dtype=dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jfw = JQ.fold_block_params_t(
        params, stats, **{k: jnp.float32(v) for k, v in AMAX_T.items()},
        compute_dtype=jdt)
    return fw, jfw


def codes(rng, cin=CIN):
    return rng.randint(0, 100, (B, H, H, cin)).astype(np.int8)


@pytest.mark.parametrize("has_ds", [False, True])
def test_fold_t_matches_jax(has_ds):
    rng = np.random.RandomState(0)
    fw, jfw = folds(rng, 64 if has_ds else CIN, has_ds)
    assert sorted(fw) == sorted(jfw)
    for k, got in fw.items():
        want = np.asarray(jfw[k])
        if k == "w2":
            want = TB.unpack_grouped_kernel(torch.from_numpy(np.array(want)),
                                            WIDTH // 32).numpy()
        assert got.dtype == torch.float32, k
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=VEC_RTOL * np.abs(want).max(),
                                   err_msg=k)
    bf16, _ = folds(np.random.RandomState(0), 64 if has_ds else CIN, has_ds,
                    torch.bfloat16)
    assert {k for k, v in bf16.items() if v.dtype == torch.bfloat16} == (
        {"w1", "w2", "w3"} | ({"wd"} if has_ds else set()))


@pytest.mark.parametrize("stride,has_ds", [(1, False), (2, True)])
def test_reference_t_matches_jax_oracle_and_pallas(stride, has_ds):
    """tests/test_quant_trunk.py:234 at f32 weights."""
    rng = np.random.RandomState(4)
    fw, jfw = folds(rng, CIN, has_ds)
    x = codes(rng)
    got = TQ.bottleneck_reference_t(torch.from_numpy(x), fw, stride=stride)
    assert got.dtype == torch.int8
    codes_close(got, JQ.bottleneck_reference_t(jnp.asarray(x), jfw,
                                               stride=stride))
    codes_close(got, J.from_hwbc(J.fused_bottleneck_hwbc(
        J.to_hwbc(jnp.asarray(x), 32), jfw, stride=stride)))
    assert 0.05 < float((got > 0).float().mean()) < 1  # not all clipped


@pytest.mark.parametrize("stride,has_ds", [(1, False), (2, True)])
def test_reference_t_bf16_matches_the_pallas_kernel(stride, has_ds):
    """At bf16 weights both keep h1 and h2 in bf16 (the TPU kernel's
    ``dt_mid``, bottleneck_hwbc.py:252-256): the port's plain version is
    held against the Pallas kernel in interpret mode in the same
    envelope."""
    rng = np.random.RandomState(5)
    fw, jfw = folds(rng, CIN, has_ds, torch.bfloat16)
    x = codes(rng)
    got = TQ.bottleneck_reference_t(torch.from_numpy(x), fw, stride=stride)
    codes_close(got, J.from_hwbc(J.fused_bottleneck_hwbc(
        J.to_hwbc(jnp.asarray(x), 32), jfw, stride=stride)))


def stage(rng, strides):
    """(port folds, JAX folds) of a 3-block stage, the head with a
    downsample (tests/test_quant_trunk.py:255-292)."""
    pairs = [folds(rng, CIN, j == 0) for j in range(len(strides))]
    return [p for p, _ in pairs], [j for _, j in pairs]


@pytest.mark.parametrize("banded", [False, True])
def test_stage_reference_t_matches_jax_stage_kernels(banded):
    """The stage kernel (stride-2 head) and the banded stage kernel
    (hh = 4, R = 4; stride 1) in interpret mode, against the port's stage
    plain version and its wrappers on CPU tensors."""
    rng = np.random.RandomState(8 if banded else 5)
    strides = [1, 1, 1] if banded else [2, 1, 1]
    fws, jfws = stage(rng, strides)
    x = codes(rng)
    xj = J.to_hwbc(jnp.asarray(x), 32)
    want = (J.fused_stage_banded(xj, jfws, strides, hh=4, R=4) if banded
            else J.fused_stage_hwbc(xj, jfws, strides))
    got = TS.stage_reference(torch.from_numpy(x), fws, strides)
    codes_close(got, J.from_hwbc(want))
    xt = torch.from_numpy(x)
    before = (TS.fused_stage.launches_t, TS.fused_stage_banded.launches_t)
    wrapped = (TS.fused_stage_banded(xt, fws, strides, 4) if banded
               else TS.fused_stage(xt, fws, strides))
    assert torch.equal(wrapped, got)
    assert (TS.fused_stage.launches_t,
            TS.fused_stage_banded.launches_t) == before


def test_cpu_wrapper_runs_the_transport_plain_version():
    """``fused_bottleneck`` picks the plain version by (x dtype, w1 dtype):
    int8 codes with a transport fold run ``bottleneck_reference_t`` on the
    CPU and count no launch."""
    rng = np.random.RandomState(6)
    fw, _ = folds(rng, CIN, True, torch.bfloat16)
    x = torch.from_numpy(codes(rng))
    counts = (TB.fused_bottleneck.launches, TB.fused_bottleneck.launches_q,
              TB.fused_bottleneck.launches_t)
    got = TB.fused_bottleneck(x, fw, stride=2)
    assert torch.equal(got, TQ.bottleneck_reference_t(x, fw, stride=2))
    assert (TB.fused_bottleneck.launches, TB.fused_bottleneck.launches_q,
            TB.fused_bottleneck.launches_t) == counts


@pytest.mark.parametrize("bad", ["ok", "no_ai", "f32_weights", "bf16_x",
                                 "int8_weights_without_scales"])
def test_transport_argument_checks(bad):
    """What the CUDA path checks before it launches K10a: int8 codes with
    bf16 weights, f32 biases and scales, ``ai`` exactly when there is no
    downsample; any other (x, w1) dtype pair has no kernel."""
    rng = np.random.RandomState(7)
    fw, _ = folds(rng, CIN, False, torch.bfloat16)
    x = torch.zeros(2, 4, 4, CIN, dtype=torch.int8)
    if bad == "no_ai":
        del fw["ai"]
    elif bad == "f32_weights":
        fw["w1"] = fw["w1"].float()
    elif bad == "bf16_x":
        x = x.to(torch.bfloat16)
    elif bad == "int8_weights_without_scales":
        fw["w3"] = fw["w3"].to(torch.int8)
    if bad == "ok":
        assert TB.block_mode(x, fw) == "t"
        TB._check_args(x, fw, 1)
    else:
        with pytest.raises(ValueError):
            TB._check_args(x, fw, 1)
