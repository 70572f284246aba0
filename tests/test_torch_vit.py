"""The port's ViT trunk against the JAX package's on the same weights.

A small VisionTransformerDino (embed 128, depth 2, 2 heads, patch 14, a
4 x 4 pos-embed grid at 56 px) is initialised by the JAX package, its
LayerNorms and biases perturbed so that they matter, and moved into the
port through ``api/convert.py``. Both run in f32 on the CPU, where the
JAX package takes its XLA path and the port its plain path. CLS features
agree to atol 1e-4 (f32, other summation orders) on the pos-embed's own
grid and on an upscaled and a downscaled one, which holds the port's
resize weights to ``jax.image.resize(method="bicubic")``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.models.vision_vit import (
    VisionTransformerDino as JViT)
from multimodal_baby_tpu_torch.api.convert import (
    load_state_dict, vit_state_dict)
from multimodal_baby_tpu_torch.models.vision_vit import (
    VisionTransformerDino, resize_weights)

KW = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2,
          base_img_size=56)


def perturb(tree, rng):
    """LayerNorm scales 1 + 0.1 N(0, 1), every bias 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "bias":
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pair():
    x = jnp.zeros((1, 56, 56, 3), jnp.float32)
    params = perturb(JViT(**KW).init(jax.random.PRNGKey(0), x)["params"],
                     np.random.RandomState(0))
    port = VisionTransformerDino(**KW, device="cpu")
    load_state_dict(port, vit_state_dict(params))
    return params, port


@pytest.mark.parametrize("size", [56, 84, 42, (56, 70)])
def test_cls_feature_matches_jax(pair, size):
    params, port = pair
    h, w = (size, size) if isinstance(size, int) else size
    x = np.random.RandomState(1).randn(2, h, w, 3).astype(np.float32)
    want = np.asarray(JViT(**KW).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(4, 6), (4, 3), (16, 9), (5, 5)])
def test_resize_weights_match_jax_image_resize(n_in, n_out):
    """Per axis, the weights reproduce jax.image.resize(bicubic) on a
    one-hot basis: Keys a = -0.5, antialiased when downscaling."""
    eye = jnp.eye(n_in, dtype=jnp.float32)
    want = np.asarray(jax.image.resize(eye, (n_in, n_out), "bicubic"))
    np.testing.assert_allclose(resize_weights(n_in, n_out).numpy(), want,
                               atol=1e-6, rtol=0)


def test_bf16_uses_the_kernel_path_on_cpu(pair):
    """In bf16 the blocks run fused_block_attention and fused_mlp (their
    plain versions on the CPU), close to the plain bf16 blocks."""
    _, port = pair
    port.dtype = torch.bfloat16
    try:
        x = torch.from_numpy(
            np.random.RandomState(2).randn(2, 56, 56, 3).astype(np.float32))
        with torch.no_grad():
            kernels = port(x)
            plain = port.forward_plain(x.bfloat16())
    finally:
        port.dtype = torch.float32
    cos = torch.nn.functional.cosine_similarity(kernels, plain, dim=1)
    assert torch.isfinite(kernels).all() and float(cos.min()) >= 0.999
