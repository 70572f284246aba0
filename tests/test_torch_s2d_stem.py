"""The space-to-depth stem, its channel pads and the augment's forms against
the JAX package's (``MMB_S2D_STEM``, ``MMB_STEM_CPAD``, ``MMB_SPLIT_STEM``,
``MMB_AUG_CSPLIT``; the JAX side reads them from the environment, set here
with monkeypatch for it alone).

- ``space_to_depth``: equal. ``augment_batch(s2d=True)`` and the
  ``csplit`` form under the JAX package's draws: the tolerances of
  ``tests/test_torch_augment.py`` (1e-6 at f32; at bf16 one bf16 ulp of the
  largest value, up to two flipped roundings on under 2% of the elements);
  without the augment, equal to ``space_to_depth`` of the normalized frames.
- The stem on the JAX package's weights (numpy-drawn, 32 px, f32): the 4x4
  convolution of ``_stem_from_s2d`` at rtol 1e-5, atol 1e-4 (the tolerance
  of ``tests/test_s2d_stem.py``); the whole trunk on a 12-channel input and
  with the channel pads at max error 1e-4 of the largest output (the f32
  trunk's tolerance, ``tests/test_torch_trunk.py``); ``stem="s2d"`` in bf16
  at 5% of the largest output (bf16 through 53 convolutions, as
  ``tests/test_torch_trunk.py``'s bf16 gate).

The train and eval steps with the split stem:
``tests/test_torch_split_stem.py``.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from multimodal_baby_tpu.data import augment as J
from multimodal_baby_tpu.models.vision_resnext import ResNeXt50 as JResNeXt50
from multimodal_baby_tpu_torch.api.convert import (
    load_state_dict, resnext50_state_dict)
from multimodal_baby_tpu_torch.data import augment as T
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.vision_resnext import ResNeXt50
from test_torch_augment import F32_ATOL, FLIP_ATOL, FLIP_SHARE, jax_draws
from test_torch_cvcl import rel_err
from test_torch_int8_trunk import random_variables

TRUNK_RTOL = 1e-4
BF16_RTOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread: beside the other test
    workers, torch's default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(0).randn(2, 8, 6, 5).astype(np.float32)
    got = T.space_to_depth(torch.from_numpy(x))
    want = np.asarray(J.space_to_depth(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape == (2, 4, 3, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def check_augment(got, want, dtype):
    """test_torch_augment's tolerance at f32 and bf16 outputs."""
    got = got.float().numpy()
    tol = F32_ATOL if dtype == "float32" else np.abs(want).max() * 2 ** -7
    err = np.abs(got - want)
    assert err.max() <= tol + FLIP_ATOL
    assert (err > tol).mean() < FLIP_SHARE


@pytest.mark.parametrize("form", ["s2d", "csplit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_forms_match_jax_on_the_same_draws(form, dtype, monkeypatch):
    b, h, w, out = 8, 40, 48, 32
    img = np.random.RandomState(0).randint(0, 256, (b, h, w, 3), np.uint8)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, b, h, w)
    if form == "csplit":
        monkeypatch.setenv("MMB_AUG_CSPLIT", "1")
    # the function under jax.jit reads the environment when it is traced:
    # run it eagerly, so that the knob set here is the one it reads
    want = np.asarray(J.augment_batch.__wrapped__(
        key, jnp.asarray(img), out_size=out, augment=True,
        dtype=getattr(jnp, dtype), s2d=form == "s2d"), np.float32)
    got = T.apply_augment(torch.from_numpy(img), draws, out,
                          getattr(torch, dtype), s2d=form == "s2d",
                          csplit=form == "csplit")
    shape = (b, out // 2, out // 2, 12) if form == "s2d" else (b, out, out, 3)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == shape
    check_augment(got, want, dtype)
    # the same slots as the default form, rearranged
    plain = T.apply_augment(torch.from_numpy(img), draws, out,
                            getattr(torch, dtype))
    if form == "s2d":
        plain = T.space_to_depth(plain)
    check_augment(got, plain.float().numpy(), dtype)


@pytest.mark.parametrize("h", [32, 48])
def test_no_augment_s2d_matches_jax(h):
    img = np.random.RandomState(1).randint(0, 256, (4, h, h, 3), np.uint8)
    want = np.asarray(J.augment_batch(jax.random.PRNGKey(0),
                                      jnp.asarray(img), out_size=32,
                                      augment=False, s2d=True))
    got = T.augment_batch(torch.from_numpy(img), 32, augment=False, s2d=True)
    assert tuple(got.shape) == want.shape == (4, 16, 16, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_ATOL if h == 32 else 1e-5)
    assert torch.equal(got, T.space_to_depth(
        T.augment_batch(torch.from_numpy(img), 32, augment=False)))


class JStem(JResNeXt50):
    """The JAX package's ``_stem_from_s2d`` alone."""

    @nn.compact
    def __call__(self, xs):
        return self._stem_from_s2d(xs)


@pytest.fixture(scope="module")
def weights():
    return random_variables(32, seed=4)


def port_trunk(weights, dtype=None, **kw):
    trunk = ResNeXt50(dtype, device="cpu", **kw)
    load_state_dict(trunk, resnext50_state_dict(*weights))
    return trunk


def frames(seed=2):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("cpad", [False, True])
def test_stem_from_s2d_matches_jax(weights, cpad, monkeypatch):
    if cpad:
        monkeypatch.setenv("MMB_STEM_CPAD", "1")
    params, _ = weights
    xs = J.space_to_depth(jnp.asarray(frames()))
    want = np.asarray(JStem().apply(
        {"params": {"conv1": params["conv1"]}}, xs))
    trunk = port_trunk(weights, stem_cpad=cpad)
    with torch.no_grad():
        got = trunk._stem_from_s2d(torch.from_numpy(np.array(xs))
                                   .permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("s2d_input,cpad", [(True, False), (True, True),
                                            (False, True)])
def test_trunk_stems_match_jax_f32(weights, s2d_input, cpad, monkeypatch):
    """The whole trunk on a 12-channel input and with the channel pads."""
    if cpad:
        monkeypatch.setenv("MMB_STEM_CPAD", "1")
    params, stats = weights
    x = jnp.asarray(frames())
    if s2d_input:
        x = J.space_to_depth(x)
    want = JResNeXt50().apply({"params": params, "batch_stats": stats}, x,
                              train=False)["pooled"]
    trunk = port_trunk(weights, stem_cpad=cpad)
    with torch.no_grad():
        got = trunk(torch.from_numpy(np.array(x)))["pooled"]
    assert tuple(got.shape) == want.shape == (2, 2048)
    assert rel_err(got, want) < TRUNK_RTOL


@pytest.mark.parametrize("cpad", [False, True])
def test_s2d_stem_bf16_matches_jax(weights, cpad, monkeypatch):
    """stem="s2d" (MMB_S2D_STEM=1) in bf16; in f32 it is the 7x7, as in the
    JAX package."""
    monkeypatch.setenv("MMB_S2D_STEM", "1")
    if cpad:
        monkeypatch.setenv("MMB_STEM_CPAD", "1")
    params, stats = weights
    x = frames()
    want = JResNeXt50(dtype=jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(x, jnp.bfloat16), train=False)["pooled"]
    trunk = port_trunk(weights, torch.bfloat16, stem="s2d", stem_cpad=cpad)
    seen = []
    real = trunk._stem_from_s2d
    trunk._stem_from_s2d = lambda xs: seen.append(xs.shape) or real(xs)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x))["pooled"]
        assert seen == [(2, 12, 16, 16)]
        f32 = port_trunk(weights, stem="s2d", stem_cpad=cpad)
        f32._stem_from_s2d = lambda xs: seen.append(xs.shape)
        f32(torch.from_numpy(x))
    assert len(seen) == 1  # f32 takes the 7x7
    assert rel_err(got, want) < BF16_RTOL


def test_stem_mode_is_checked():
    for bad in ("s2D", "7x7", None):
        with pytest.raises(ValueError):
            ResNeXt50(device="cpu", stem=bad)
        with pytest.raises(ValueError):
            KernelConfig(stem=bad)
