"""K11's plain version (``ops/conv_epilogue.py``) and ``BottleneckX``'s
``fused_epilogue`` against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages. The forward is
held against JAX's ``conv1x1_bn_residual_relu`` (the Pallas kernel in
interpret mode where M has a power-of-two divisor of at least 8, else its
XLA path) and ``_xla_epilogue`` at ``tests/test_ops.py:93-107``'s shapes in
f32 (atol 1e-5, that test's), and in bf16, where both compute in f32 and
round once to bf16: within one bf16 step (2^-7 of the value) where the f32
sums, taken in other orders, straddle a rounding. The gradients are held
against ``jax.vjp`` of ``_xla_epilogue`` (f32, rtol and atol 1e-5: sums
over M in other orders). The block: ``BottleneckX(fused_epilogue=True)``
against ``BottleneckX()`` and against the flax block with the same flag and
weights; K11 itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.models.vision_resnext import (
    BottleneckX as JBottleneckX)
from multimodal_baby_tpu.ops.conv_epilogue import (
    _xla_epilogue, conv1x1_bn_residual_relu as j_epilogue)
from multimodal_baby_tpu_torch.models.vision_resnext import (
    BottleneckX, ResNeXt50)
from multimodal_baby_tpu_torch.ops import conv_epilogue as TE

ATOL = 1e-5          # tests/test_ops.py:105
GRAD_TOL = 1e-5
BF16_STEP = 2.0 ** -7


def inputs(M, cin, cout, seed=0):
    """tests/test_ops.py:96-101's distributions, as numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randn(M, cin).astype(np.float32),
            (rng.randn(cin, cout) * 0.1).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32),
            rng.randn(M, cout).astype(np.float32))


@pytest.mark.parametrize("M", [64, 6, 100])
def test_forward_matches_jax_f32(M):
    """M = 64 takes JAX's Pallas kernel (tile 64); 6 and 100 (largest
    power-of-two divisor 2 and 4) its XLA path. The port takes any M."""
    args = inputs(M, 16, 32)
    got = TE.conv1x1_bn_residual_relu(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and float(got.min()) >= 0.0
    for want in (j_epilogue(*map(jnp.asarray, args)),
                 _xla_epilogue(*map(jnp.asarray, args))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_forward_matches_jax_bf16():
    """bf16 x, w and residual (the kernel's types), f32 mul and add; the
    output in the residual's dtype."""
    args = list(inputs(256, 128, 256, seed=1))
    for i in (0, 1, 4):
        args[i] = args[i].astype(jnp.bfloat16)
    t_args = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    for i in (0, 1, 4):
        t_args[i] = t_args[i].to(torch.bfloat16)
    got = TE.conv1x1_bn_residual_relu(*t_args)
    assert got.dtype == torch.bfloat16
    want = np.asarray(_xla_epilogue(*map(jnp.asarray, args)), np.float32)
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= BF16_STEP * np.abs(want))
    assert (got != want).mean() < 1e-3


def test_gradients_match_jax_vjp():
    args = inputs(64, 16, 32, seed=2)
    g = np.random.RandomState(3).randn(64, 32).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = TE.conv1x1_bn_residual_relu(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(_xla_epilogue, *map(jnp.asarray, args))
    for name, a, b in zip(("x", "w", "mul", "add", "residual"), got,
                          vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_kernel_function_backward_is_the_plain_autograd(monkeypatch):
    """The autograd.Function the CUDA path takes, with the kernel launch
    replaced by the plain version on the CPU: its forward and every
    gradient equal the plain version's autograd, and an input that needs
    no gradient gets none."""
    monkeypatch.setattr(TE, "_launch", TE.epilogue_reference)
    args = [torch.from_numpy(a) for a in inputs(32, 16, 32, seed=4)]
    leaves = [a.clone().requires_grad_(i != 2) for i, a in enumerate(args)]
    plain = [a.clone().requires_grad_(i != 2) for i, a in enumerate(args)]
    got = TE._Epilogue.apply(*leaves)
    want = TE.epilogue_reference(*plain)
    assert torch.equal(got, want)
    g = torch.randn(32, 32, generator=torch.Generator().manual_seed(5))
    wanted = [t for t in leaves if t.requires_grad]
    for a, b in zip(torch.autograd.grad(got, wanted, g),
                    torch.autograd.grad(want, [t for t in plain
                                               if t.requires_grad], g)):
        assert torch.equal(a, b)


def test_cpu_wrapper_counts_nothing():
    args = [torch.from_numpy(a) for a in inputs(8, 16, 32)]
    before = TE.conv1x1_bn_residual_relu.launches
    TE.conv1x1_bn_residual_relu(*args)
    assert TE.conv1x1_bn_residual_relu.launches == before


# ------------------------------------------------------------- the block

def block_weights(rng, cin, planes, has_ds):
    """A port BottleneckX state dict (numpy) and the flax block's params
    and batch stats with the same values."""
    width, cout = planes * 2, planes * 4
    convs = {"conv1": (width, cin, 1), "conv2": (width, width // 32, 3),
             "conv3": (cout, width, 1)}
    bns = {"bn1": width, "bn2": width, "bn3": cout}
    if has_ds:
        convs["downsample_conv"] = (cout, cin, 1)
        bns["downsample_bn"] = cout
    torch_name = {"downsample_conv": "downsample.0",
                  "downsample_bn": "downsample.1"}
    sd, params, stats = {}, {}, {}
    for name, (o, i, k) in convs.items():
        w = (rng.randn(o, i, k, k) * np.sqrt(2 / (i * k * k))).astype(
            np.float32)
        sd[f"{torch_name.get(name, name)}.weight"] = w
        params[name] = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}
    for name, c in bns.items():
        v = {"weight": 1 + .1 * rng.randn(c), "bias": .1 * rng.randn(c),
             "running_mean": .1 * rng.randn(c),
             "running_var": rng.uniform(.5, 2., c)}
        v = {k: a.astype(np.float32) for k, a in v.items()}
        for k, a in v.items():
            sd[f"{torch_name.get(name, name)}.{k}"] = a
        params[name] = {"scale": jnp.asarray(v["weight"]),
                        "bias": jnp.asarray(v["bias"])}
        stats[name] = {"mean": jnp.asarray(v["running_mean"]),
                       "var": jnp.asarray(v["running_var"])}
    return sd, params, stats


@pytest.mark.parametrize("stride,has_ds,cin", [(1, False, 256),
                                               (2, True, 256)])
def test_fused_epilogue_block_matches_plain_block_and_flax(
        monkeypatch, stride, has_ds, cin):
    """f32 on the CPU: the flag leaves the conv path alone there (as the
    JAX package's does off the TPU), so the block equals BottleneckX()
    exactly; with the K11 route forced, its plain version gives the same
    block to f32 rounding; both equal the flax block with the flag."""
    rng = np.random.RandomState(6 + stride)
    planes = 64
    sd, params, stats = block_weights(rng, cin, planes, has_ds)
    blocks = [BottleneckX(cin, planes, stride, has_ds, device="cpu",
                          fused_epilogue=flag) for flag in (True, False)]
    for b in blocks:
        b.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        b.eval()
    x = np.maximum(rng.randn(4, 8, 8, cin), 0).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view of NHWC
    with torch.no_grad():
        fused, plain = (b(xt).permute(0, 2, 3, 1) for b in blocks)
        assert torch.equal(fused, plain)
        calls = []
        monkeypatch.setattr(BottleneckX, "use_epilogue",
                            lambda self, y, bs: self.fused_epilogue)
        real = TE.conv1x1_bn_residual_relu
        monkeypatch.setattr(
            "multimodal_baby_tpu_torch.models.vision_resnext."
            "conv1x1_bn_residual_relu",
            lambda *a: calls.append(1) or real(*a))
        routed = blocks[0](xt).permute(0, 2, 3, 1)
    assert calls == [1]
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = JBottleneckX(planes=planes, stride=stride, has_downsample=has_ds,
                        fused_epilogue=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    # f32 convolutions of two libraries through the block's four layers
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_resnext_leaves_the_flag_off():
    """vision_resnext.py:586: the trunk builds its blocks without it."""
    trunk = ResNeXt50(device="cpu")
    assert not any(b.fused_epilogue for b in trunk.blocks())
