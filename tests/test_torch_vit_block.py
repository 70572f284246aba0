"""The port's whole-block kernel (K7 ``fused_vit_block``) and the GELU forms
of the MLP half (K6 ``fused_mlp``) against the JAX package's Pallas
kernels of the same names, which run here in interpret mode as
tests/test_ops.py runs them.

The same numpy-seeded inputs go through both; on CPU tensors the port's
wrappers run their plain versions (``vit_block_reference``,
``mlp_reference``). Tolerances:

- f32: atol and rtol 3e-5 for K7 (the JAX test's bound,
  tests/test_ops.py:612-614: the Pallas erf is a rational erfc, |delta
  GELU| <= 2.5e-6, and the attention sums in another order), 2e-5 for K6
  (tests/test_torch_vit_ops.py);
- bf16: K7's plain version equals the port's K5 then K6 plain versions
  bit for bit (the kernel's own bf16 rounding of y between the halves);
  against the JAX kernel, max error relative to the largest output <= 1e-2
  and cosine >= 0.9999;
- kv_valid = 7 at N = 10: poisoned pad tokens change no real-token output
  (atol 1e-4, the JAX test's);
- gradients, through the JAX custom VJPs and the port's PlainVJP: atol and
  rtol 1e-4, the JAX tests' bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.ops.vit_block import fused_vit_block as j_block
from multimodal_baby_tpu.ops.vit_block import (
    should_fuse_vit_block as j_should_fuse)
from multimodal_baby_tpu.ops.vit_mlp import fused_mlp as j_mlp
from multimodal_baby_tpu.ops.vit_mlp import should_fuse_mlp as j_fuse_mlp
from multimodal_baby_tpu_torch.ops.attention import fused_block_attention
from multimodal_baby_tpu_torch.ops.vit_block import (
    fused_vit_block, should_fuse_vit_block, vit_block_reference)
from multimodal_baby_tpu_torch.ops.vit_mlp import (
    fused_mlp, mlp_reference, should_fuse_mlp)

B, N, H, D, F = 2, 10, 2, 64, 512
C = H * D
SCALE = D ** -0.5
EPS = 1e-6
GELUS = ["erf", "tanh", "sigmoid"]


def make_inputs(seed):
    """x and the 12 block operands (LayerNorm 1, qkv, proj, LayerNorm 2,
    fc1, fc2) as f32 numpy arrays, as tests/test_ops.py:592-601 makes
    them."""
    rng = np.random.RandomState(seed)

    def arr(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)

    return [arr(B, N, C), 1.0 + arr(C, s=0.1), arr(C, s=0.1),
            arr(C, 3 * C, s=C ** -0.5), arr(3 * C, s=0.1),
            arr(C, C, s=C ** -0.5), arr(C, s=0.1), 1.0 + arr(C, s=0.1),
            arr(C, s=0.1), arr(C, F, s=C ** -0.5), arr(F, s=0.1),
            arr(F, C, s=F ** -0.5), arr(C, s=0.1)]


def run_jax(arrs, dtype, gelu, kv_valid=None):
    x, *p = [jnp.asarray(a) for a in arrs]
    out = j_block(x.astype(dtype), *p, H, SCALE, kv_valid, EPS, gelu)
    return np.asarray(out.astype(jnp.float32))


def run_port(arrs, dtype, gelu, kv_valid=None, fn=fused_vit_block):
    x, *p = [torch.from_numpy(a) for a in arrs]
    with torch.no_grad():
        out = fn(x.to(dtype), *p, H, SCALE, kv_valid, EPS, gelu)
    assert out.dtype == dtype and tuple(out.shape) == (B, N, C)
    return out


def close_bf16(got, want):
    got, want = got.astype(np.float64), want.astype(np.float64)
    rel = np.abs(got - want).max() / np.abs(want).max()
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)


@pytest.mark.parametrize("gelu", GELUS)
def test_f32_matches_pallas_kernel(gelu):
    arrs = make_inputs(1)
    want = run_jax(arrs, jnp.float32, gelu)
    got = run_port(arrs, torch.float32, gelu).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("gelu", GELUS)
def test_bf16_is_the_two_halves_bit_for_bit(gelu):
    arrs = make_inputs(2)
    got = run_port(arrs, torch.bfloat16, gelu)
    x, *p = [torch.from_numpy(a) for a in arrs]
    with torch.no_grad():
        y = fused_block_attention(x.bfloat16(), *p[:6], H, SCALE, None, EPS)
        composed = fused_mlp(y, *p[6:], EPS, gelu)
    assert torch.equal(got.view(torch.int16), composed.view(torch.int16))
    close_bf16(got.float().numpy(), run_jax(arrs, jnp.bfloat16, gelu))


def test_kv_valid_masks_pad_tokens():
    arrs = make_inputs(3)
    x, *p = [torch.from_numpy(a) for a in arrs]
    padded = x.clone()
    padded[:, 7:] = 1e3
    got = fused_vit_block(padded, *p, H, SCALE, 7)[:, :7]
    want = fused_vit_block(x[:, :7].contiguous(), *p, H, SCALE)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        run_port(arrs, torch.float32, "erf", 7).numpy(),
        run_jax(arrs, jnp.float32, "erf", 7), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_gradients_match_jax_custom_vjp(gelu):
    arrs = make_inputs(4)
    want = jax.grad(
        lambda *a: (j_block(*a, H, SCALE, 7, EPS, gelu) ** 2).sum(),
        argnums=tuple(range(13)))(*[jnp.asarray(a) for a in arrs])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (fused_vit_block(*ts, H, SCALE, 7, EPS, gelu) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gelu", ["tanh", "sigmoid"])
def test_mlp_gelu_forms_match_pallas_kernel(gelu, dtype):
    arrs = make_inputs(5)
    x, p = arrs[0], arrs[7:]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(j_mlp(jnp.asarray(x).astype(jdt),
                            *map(jnp.asarray, p), EPS, gelu
                            ).astype(jnp.float32))
    with torch.no_grad():
        got = fused_mlp(torch.from_numpy(x).to(tdt),
                        *map(torch.from_numpy, p), EPS, gelu).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        close_bf16(got, want)


@pytest.mark.parametrize("gelu", ["tanh", "sigmoid"])
def test_mlp_gelu_form_gradients_match_jax(gelu):
    arrs = make_inputs(6)
    a = [arrs[0]] + arrs[7:]
    want = jax.grad(lambda *t: (j_mlp(*t, EPS, gelu) ** 2).sum(),
                    argnums=tuple(range(7)))(*map(jnp.asarray, a))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in a]
    (fused_mlp(*ts, EPS, gelu) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,heads,d,hidden", [
    (272, 12, 64, 3072), (272, 12, 64, 3070), (257, 12, 64, 3072),
    (257, 16, 64, 4096), (257, 11, 64, 3072), (1200, 12, 64, 3072)])
def test_gates_match_jax(n, heads, d, hidden):
    assert should_fuse_vit_block(n, heads, d, hidden) == j_should_fuse(
        n, heads, d, hidden)
    assert should_fuse_mlp(n, heads * d, hidden) == j_fuse_mlp(
        n, heads * d, hidden)


def test_unknown_gelu_mode_raises():
    arrs = make_inputs(7)
    x, *p = [torch.from_numpy(a) for a in arrs]
    for fn, args in ((fused_vit_block, (*p, H, SCALE, None, EPS, "relu")),
                     (vit_block_reference, (*p, H, SCALE, None, EPS, "Erf")),
                     (fused_mlp, (*p[6:], EPS, "gelu")),
                     (mlp_reference, (*p[6:], EPS, ""))):
        with pytest.raises(ValueError, match="gelu"):
            fn(x, *args)
