"""The port's augment against the JAX package's ``augment_batch``.

The JAX side's boxes, flips and blur are drawn with the key split that
``augment_batch`` makes inside (``k_crop, k_blur_p, k_blur_s, k_flip``)
and handed to the port's ``apply_augment``; both then resample the same
uint8 frames with the same bf16 products. Tolerance: an element matches to
1e-6 at f32 output, to one bf16 ulp of the largest value at bf16 output,
except where a bf16 rounding of the two resampling products went the other
way (the CPU's bf16 matmul kernels may sum in another order): those may be
off by at most two such flips, FLIP_ATOL, and must stay under 2% of the
elements.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.data import augment as J
from multimodal_baby_tpu_torch.data import augment as T

F32_ATOL = 1e-6
# two bf16 ulps of a resampled pixel in [0.5, 1), after the normalize's 1/std
FLIP_ATOL = 2 * 2 ** -8 / min(J.IMAGENET_STD)
FLIP_SHARE = 0.02


def jax_draws(key, b, h, w):
    """The draws augment_batch(key, ...) makes, as the port's AugmentDraws."""
    k_crop, k_blur_p, k_blur_s, k_flip = jax.random.split(key, 4)
    boxes = jax.vmap(lambda k: J._sample_crop_box(k, (h, w)))(
        jax.random.split(k_crop, b))
    sigmas = jax.random.uniform(k_blur_s, (b,), minval=0.1, maxval=2.0)
    do_blur = jax.random.bernoulli(k_blur_p, 0.5, (b,))
    do_flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    return T.AugmentDraws(*(torch.from_numpy(np.array(a)) for a in (
        boxes, do_flip, do_blur, sigmas)))


# out 32 > 2 * blur radius: JAX builds the blur band by its Toeplitz trick;
# out 8: by its dense construction. The port has one dense construction.
@pytest.mark.parametrize("h,w,out", [(40, 48, 32), (24, 20, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax_on_the_same_draws(h, w, out, dtype):
    b = 8
    img = np.random.RandomState(0).randint(0, 256, (b, h, w, 3), np.uint8)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, b, h, w)
    # the seed gives both outcomes of each coin
    assert 0 < int(draws.do_flip.sum()) < b
    assert 0 < int(draws.do_blur.sum()) < b
    want = np.asarray(J.augment_batch(
        key, jnp.asarray(img), out_size=out, augment=True,
        dtype=getattr(jnp, dtype)), np.float32)
    got = T.apply_augment(torch.from_numpy(img), draws, out,
                          getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (b, out, out, 3)
    tol = F32_ATOL if dtype == "float32" else np.abs(want).max() * 2 ** -7
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= tol + FLIP_ATOL
    assert (err > tol).mean() < FLIP_SHARE


@pytest.mark.parametrize("h,w", [(32, 32), (48, 40)])
def test_no_augment_matches_jax(h, w):
    """augment=False: the exact normalize at the output size, and the
    antialiased bilinear resize otherwise."""
    img = np.random.RandomState(1).randint(0, 256, (4, h, w, 3), np.uint8)
    want = np.asarray(J.augment_batch(jax.random.PRNGKey(0),
                                      jnp.asarray(img), out_size=32,
                                      augment=False))
    got = T.augment_batch(torch.from_numpy(img), 32, augment=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_ATOL if h == 32 else 1e-5)


def test_sampler_draws_valid_parameters():
    """The port's sampler: boxes inside the frame with sides in [8, side],
    both outcomes of the flip and blur coins, sigma in [0.1, 2], and the
    same draws from the same seed."""
    g = torch.Generator().manual_seed(0)
    d = T.sample_augment(256, (60, 80), g)
    y0, x0, h, w = d.boxes.unbind(1)
    assert bool(((h >= 8) & (h <= 60) & (w >= 8) & (w <= 80)).all())
    assert bool(((y0 >= 0) & (y0 + h <= 60 + 1e-4)).all())
    assert bool(((x0 >= 0) & (x0 + w <= 80 + 1e-4)).all())
    assert 0.3 < float(d.do_flip.float().mean()) < 0.7
    assert 0.3 < float(d.do_blur.float().mean()) < 0.7
    assert bool(((d.sigmas >= 0.1) & (d.sigmas <= 2.0)).all())
    again = T.sample_augment(256, (60, 80), torch.Generator().manual_seed(0))
    for a, b in zip(d, again):
        assert torch.equal(a, b)
    img = torch.randint(0, 256, (4, 60, 80, 3), dtype=torch.uint8)
    out = T.augment_batch(img, 32, generator=torch.Generator().manual_seed(1))
    assert tuple(out.shape) == (4, 32, 32, 3)
    assert bool(torch.isfinite(out).all())
