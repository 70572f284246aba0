"""The port's ResNeXt-50 trunk against the JAX package's conv path on the CPU.

Full width, B = 4, 64x64 px, f32, in both BN modes (running statistics,
and batch statistics with the running buffers updated: the reference's
frozen-CNN quirk), on the same weights moved through the port's weight
bridge. Tolerance: max error relative to the largest output < 1e-4 (f32
through 53 convolutions with other summation orders); 2e-3 with batch
statistics, where the JAX side itself is 5e-4 from a float64 run of the
port at this size (E[x^2] - E[x]^2 over 16 values per channel at layer 4,
where the port is 1e-4 from it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.models.vision_resnext import ResNeXt50 as JResNeXt50
from multimodal_baby_tpu_torch.api.convert import (
    load_state_dict, resnext50_state_dict)
from multimodal_baby_tpu_torch.models.vision_resnext import ResNeXt50
from multimodal_baby_tpu_torch.ops.bottleneck import fused_bottleneck

RTOL = 1e-4
BATCH_RTOL = 2e-3
BF16_RTOL = 0.05  # bf16 folded vs bf16 conv path, as tests/test_hwbc_kernels


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def make_weights():
    """JAX-initialised trunk variables with non-trivial BN parameters and
    statistics, and the same weights as a port state dict."""
    x = np.random.RandomState(0).randn(4, 64, 64, 3).astype(np.float32)
    variables = JResNeXt50().init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(1)

    def perturb(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v, kind)
                continue
            n = v.shape
            if kind == "stats":
                out[k] = (rng.uniform(.5, 2., n) if k == "var"
                          else .1 * rng.randn(*n)).astype(np.float32)
            elif k == "scale":
                out[k] = (1 + .1 * rng.randn(*n)).astype(np.float32)
            elif k == "bias":
                out[k] = (.1 * rng.randn(*n)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    params = perturb(jax.device_get(variables["params"]), "params")
    stats = perturb(jax.device_get(variables["batch_stats"]), "stats")
    return params, stats


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def port_trunk(weights, dtype=None):
    params, stats = weights
    trunk = ResNeXt50(dtype, frozen=True)
    load_state_dict(trunk, resnext50_state_dict(params, stats))
    return trunk


@pytest.mark.parametrize("train", [False, True])
def test_trunk_matches_jax_conv_path(weights, train):
    params, stats = weights
    x = np.random.RandomState(2).randn(4, 64, 64, 3).astype(np.float32)
    want, updated = JResNeXt50().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=train, mutable=["batch_stats"])
    trunk = port_trunk(weights)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x), train=train)
    assert tuple(got["feature_map"].shape) == (4, 2, 2, 2048)
    for k in ("pooled", "feature_map"):
        assert tuple(got[k].shape) == want[k].shape
        assert rel_err(got[k], want[k]) < (BATCH_RTOL if train else RTOL), k
    if train:  # running statistics updated as flax updates them
        new = resnext50_state_dict(params, updated["batch_stats"])
        sd = trunk.state_dict()
        for k, v in new.items():
            if "running" in k:
                assert rel_err(sd[k], v) < BATCH_RTOL, k


def test_folded_path_matches_conv_path_f32(weights):
    """The all-blocks folded path (the CPU's plain K1 version) computes
    the conv path's function in running-BN mode."""
    trunk = port_trunk(weights)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(4, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        conv = trunk.forward_conv(x)
        folded = trunk.forward_folded(x)
    for k in ("pooled", "feature_map"):
        assert rel_err(folded[k], conv[k]) < RTOL, k


def test_folded_path_matches_conv_path_bf16(weights):
    trunk = port_trunk(weights, torch.bfloat16)
    x = torch.from_numpy(
        np.random.RandomState(4).randn(4, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        xb = x.to(torch.bfloat16)
        conv = trunk.forward_conv(xb)
        folded = trunk.forward_folded(xb)
        before = fused_bottleneck.launches
        dispatched = trunk(x)  # CPU tensor: the conv path
    assert fused_bottleneck.launches == before
    assert folded["feature_map"].dtype == torch.bfloat16
    assert folded["pooled"].dtype == torch.float32
    for k in ("pooled", "feature_map"):
        assert rel_err(folded[k].float(), conv[k].float()) < BF16_RTOL, k
        assert torch.equal(dispatched[k], conv[k]), k


def test_fold_is_cached_per_weight_state(weights):
    trunk = port_trunk(weights)
    first = trunk.folded(torch.float32)
    assert trunk.folded(torch.float32) is first
    assert len(first) == 16
    assert [s for _, s in first] == [1, 1, 1, 2, 1, 1, 1, 2, 1, 1, 1, 1, 1,
                                     2, 1, 1]
    # the head is not part of the fold: a head update keeps the cache
    trunk.fc = torch.nn.Linear(2048, 8)
    with torch.no_grad():
        trunk.fc.weight.add_(1.0)
    assert trunk.folded(torch.float32) is first
    # an in-place update of a block tensor refolds
    with torch.no_grad():
        trunk.layer3[1].bn2.running_var.mul_(2.0)
    second = trunk.folded(torch.float32)
    assert second is not first
    assert not torch.equal(second[8][0]["w2"], first[8][0]["w2"])
    assert torch.equal(second[7][0]["w2"], first[7][0]["w2"])
