"""The port's ViT block halves (K5, K6) against the JAX package's Pallas
kernels, which run here in interpret mode as tests/test_ops.py runs them.

The same numpy-seeded inputs go through the JAX ``fused_block_attention``
and ``fused_mlp`` and through the port's functions of the same names,
which on CPU tensors run their plain versions (``block_attention_reference``,
``mlp_reference``). Tolerances:

- f32: atol and rtol 2e-5, the JAX tests' own bound (the Pallas MLP uses a
  rational erf, |delta GELU| <= 2.5e-6; the attention sums in another
  order);
- bf16: max error relative to the largest output <= 1e-2 and cosine >=
  0.9999 (both round at the same points; f32 sums in another order can
  move a rounding by one bf16 ulp);
- gradients, through the JAX custom VJPs and the port's autograd
  Functions: atol and rtol 1e-4, the JAX tests' bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.ops.attention import (
    fused_block_attention as j_attention)
from multimodal_baby_tpu.ops.vit_mlp import fused_mlp as j_mlp
from multimodal_baby_tpu_torch.ops.attention import (
    block_attention_reference, fused_block_attention)
from multimodal_baby_tpu_torch.ops.vit_mlp import fused_mlp, mlp_reference

B, N, H, D, F = 2, 10, 4, 64, 512
C = H * D
SCALE = D ** -0.5
EPS = 1e-6


def make_inputs(kind, seed):
    """(x, ln scale, ln bias, w_a, b_a, w_b, b_b) as f32 numpy arrays:
    qkv and proj weights for the attention half, fc1 and fc2 for the MLP."""
    rng = np.random.RandomState(seed)
    out_a, in_b = (3 * C, C) if kind == "attention" else (F, F)
    arrs = [rng.randn(B, N, C), 1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C),
            rng.randn(C, out_a) / np.sqrt(C), 0.1 * rng.randn(out_a),
            rng.randn(in_b, C) / np.sqrt(in_b), 0.1 * rng.randn(C)]
    return [a.astype(np.float32) for a in arrs]


def run_jax(kind, arrs, dtype, kv_valid=None):
    x, *params = [jnp.asarray(a) for a in arrs]
    x = x.astype(dtype)
    if kind == "attention":
        out = j_attention(x, *params, H, SCALE, kv_valid, EPS)
    else:
        out = j_mlp(x, *params, EPS, "erf")
    return np.asarray(out.astype(jnp.float32))


def run_port(kind, arrs, dtype, fn, kv_valid=None):
    x, *params = [torch.from_numpy(a) for a in arrs]
    x = x.to(dtype)
    with torch.no_grad():
        if kind == "attention":
            out = fn(x, *params, H, SCALE, kv_valid, EPS)
        else:
            out = fn(x, *params, EPS)
    assert out.dtype == dtype and tuple(out.shape) == (B, N, C)
    return out.float().numpy()


CASES = [("attention", None), ("attention", 7), ("mlp", None)]


@pytest.mark.parametrize("kind,kv_valid", CASES)
def test_f32_matches_pallas_kernel(kind, kv_valid):
    fn = block_attention_reference if kind == "attention" else mlp_reference
    arrs = make_inputs(kind, 1)
    want = run_jax(kind, arrs, jnp.float32, kv_valid)
    got = run_port(kind, arrs, torch.float32, fn, kv_valid)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind,kv_valid", CASES)
def test_bf16_matches_pallas_kernel(kind, kv_valid):
    fn = fused_block_attention if kind == "attention" else fused_mlp
    arrs = make_inputs(kind, 2)
    want = run_jax(kind, arrs, jnp.bfloat16, kv_valid).astype(np.float64)
    got = run_port(kind, arrs, torch.bfloat16, fn, kv_valid).astype(
        np.float64)
    rel = np.abs(got - want).max() / np.abs(want).max()
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)


def test_kv_valid_masks_pad_keys():
    """Real-token rows see only the first kv_valid keys: the same as the
    unpadded computation on those tokens, whatever the pad tokens hold."""
    arrs = make_inputs("attention", 3)
    x = torch.from_numpy(arrs[0])
    params = [torch.from_numpy(a) for a in arrs[1:]]
    padded = x.clone()
    padded[:, 7:] = 1e3
    got = fused_block_attention(padded, *params, H, SCALE, 7)[:, :7]
    want = fused_block_attention(x[:, :7].contiguous(), *params, H, SCALE)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind,kv_valid", CASES)
def test_gradients_match_jax_custom_vjp(kind, kv_valid):
    arrs = make_inputs(kind, 4)
    if kind == "attention":
        def j_loss(*a):
            return (j_attention(*a, H, SCALE, kv_valid, EPS) ** 2).sum()
    else:
        def j_loss(*a):
            return (j_mlp(*a, EPS, "erf") ** 2).sum()
    want = jax.grad(j_loss, argnums=tuple(range(7)))(
        *[jnp.asarray(a) for a in arrs])

    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    if kind == "attention":
        out = fused_block_attention(*ts, H, SCALE, kv_valid, EPS)
    else:
        out = fused_mlp(*ts, EPS)
    (out ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_wrappers_refuse_other_devices():
    arrs = make_inputs("mlp", 5)
    x, *params = [torch.from_numpy(a).to("meta") for a in arrs]
    before = fused_mlp.launches
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp(x, *params)
    assert fused_mlp.launches == before
