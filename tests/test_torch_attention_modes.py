"""The port's opt-in attention kernels (K8a ``fused_attention``, K8b
``fused_attention_pairs``, K8c ``fused_qkv_attention_pairs``) against the
JAX package's Pallas kernels of the same names, which run here in
interpret mode as tests/test_ops.py runs them.

The same numpy-seeded inputs go through both; on CPU tensors the port's
wrappers run their plain versions (``attention_reference``,
``attention_pairs_reference``, ``qkv_attention_pairs_reference``).
Tolerances:

- f32: atol and rtol 2e-5 (the TPU kernels' +/- pair trick and other
  summation orders move the last bits; tests/test_ops.py holds the
  kernels to their XLA oracles at 1e-5);
- bf16: max error relative to the largest output <= 1e-2 and cosine >=
  0.9999 (both round p and q, k, v at the same points; another summation
  order can move a rounding of p by one bf16 ulp);
- kv_valid = 7 at N = 10: poisoned pad tokens change no real-token output
  (atol 1e-5);
- gradients, through the JAX custom VJPs and the port's PlainVJP: atol and
  rtol 1e-4, the JAX tests' bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.ops import attention as jatt
from multimodal_baby_tpu_torch.ops import attention as tatt

B, N, H, D = 2, 10, 4, 64
C = H * D
SCALE = D ** -0.5
KINDS = ["heads_first", "pairs", "qkv"]


def make_inputs(kind, seed):
    """f32 numpy operands: q, k, v ([B*H, N, d] or [B, N, C]) or x, wqkv,
    bqkv."""
    rng = np.random.RandomState(seed)
    if kind == "heads_first":
        arrs = [rng.randn(B * H, N, D) for _ in range(3)]
    elif kind == "pairs":
        arrs = [rng.randn(B, N, C) for _ in range(3)]
    else:
        arrs = [rng.randn(B, N, C), rng.randn(C, 3 * C) / np.sqrt(C),
                0.1 * rng.randn(3 * C)]
    return [a.astype(np.float32) for a in arrs]


def jax_fn(kind):
    if kind == "heads_first":
        return lambda q, k, v, kv=None: jatt.fused_attention(q, k, v, SCALE,
                                                             kv)
    if kind == "pairs":
        return lambda q, k, v, kv=None: jatt.fused_attention_pairs(
            q, k, v, H, SCALE, kv)
    return lambda x, w, b, kv=None: jatt.fused_qkv_attention_pairs(
        x, w, b, H, SCALE, kv)


def port_fn(kind):
    if kind == "heads_first":
        return lambda q, k, v, kv=None: tatt.fused_attention(q, k, v, SCALE,
                                                             kv)
    if kind == "pairs":
        return lambda q, k, v, kv=None: tatt.fused_attention_pairs(
            q, k, v, H, SCALE, kv)
    return lambda x, w, b, kv=None: tatt.fused_qkv_attention_pairs(
        x, w, b, H, SCALE, kv)


def run_jax(kind, arrs, dtype, kv_valid=None):
    a = [jnp.asarray(t) for t in arrs]
    a[0] = a[0].astype(dtype)
    if kind != "qkv":
        a = [t.astype(dtype) for t in a]
    return np.asarray(jax_fn(kind)(*a, kv_valid).astype(jnp.float32))


def run_port(kind, arrs, dtype, kv_valid=None):
    a = [torch.from_numpy(t) for t in arrs]
    a[0] = a[0].to(dtype)
    if kind != "qkv":
        a = [t.to(dtype) for t in a]
    with torch.no_grad():
        out = port_fn(kind)(*a, kv_valid)
    assert out.dtype == dtype and tuple(out.shape) == arrs[0].shape
    return out.float().numpy()


@pytest.mark.parametrize("kv_valid", [None, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_f32_matches_pallas_kernel(kind, kv_valid):
    arrs = make_inputs(kind, 1)
    want = run_jax(kind, arrs, jnp.float32, kv_valid)
    got = run_port(kind, arrs, torch.float32, kv_valid)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kv_valid", [None, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_matches_pallas_kernel(kind, kv_valid):
    arrs = make_inputs(kind, 2)
    want = run_jax(kind, arrs, jnp.bfloat16, kv_valid).astype(np.float64)
    got = run_port(kind, arrs, torch.bfloat16, kv_valid).astype(np.float64)
    rel = np.abs(got - want).max() / np.abs(want).max()
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert rel <= 1e-2 and cos >= 0.9999, (rel, cos)


@pytest.mark.parametrize("kind", KINDS)
def test_kv_valid_masks_pad_tokens(kind):
    """Real-token rows see only the first kv_valid tokens: the same as the
    unpadded computation on those tokens, whatever the pad tokens hold."""
    arrs = make_inputs(kind, 3)
    full = [torch.from_numpy(a) for a in arrs]
    poisoned = [t.clone() for t in full]
    for t in (poisoned if kind != "qkv" else poisoned[:1]):
        t[:, 7:] = 1e3
    cut = [t[:, :7].contiguous() for t in (full if kind != "qkv"
                                           else full[:1])]
    if kind == "qkv":
        cut += full[1:]
    got = port_fn(kind)(*poisoned, 7)[:, :7]
    want = port_fn(kind)(*cut)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_valid", [None, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_custom_vjp(kind, kv_valid):
    arrs = make_inputs(kind, 4)
    fn = jax_fn(kind)
    want = jax.grad(lambda *a: (fn(*a, kv_valid) ** 2).sum(),
                    argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrs])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (port_fn(kind)(*ts, kv_valid) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_qkv_views_and_no_bias():
    """K8b takes the column slices of one qkv tensor as they are, and K8c
    without a bias is K8c with a zero bias."""
    x, w, b = (torch.from_numpy(a) for a in make_inputs("qkv", 5))
    qkv = x @ w
    got = tatt.fused_attention_pairs(qkv[..., :C], qkv[..., C:2 * C],
                                     qkv[..., 2 * C:], H, SCALE)
    want = tatt.fused_attention_pairs(*(t.contiguous()
                                        for t in qkv.split(C, -1)), H, SCALE)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        tatt.fused_qkv_attention_pairs(x, w, None, H, SCALE),
        tatt.fused_qkv_attention_pairs(x, w, torch.zeros(3 * C), H, SCALE),
        atol=0, rtol=0)


@pytest.mark.parametrize("n,heads,d", [
    (257, 12, 64), (272, 12, 64), (257, 12, 96), (257, 11, 64),
    (1500, 12, 64), (3000, 2, 64), (257, 24, 64), (257, 40, 64)])
def test_gates_match_jax(n, heads, d):
    for name, args in (("should_fuse_attention", (n, d)),
                       ("should_fuse_attention_pairs", (n, heads, d)),
                       ("should_fuse_qkv_attention_pairs", (n, heads, d)),
                       ("should_fuse_block_attention", (n, heads, d))):
        assert getattr(tatt, name)(*args) == getattr(jatt, name)(*args), name


def test_wrappers_refuse_other_devices():
    q, k, v = (torch.from_numpy(a).to("meta")
               for a in make_inputs("pairs", 6))
    for fn, counter in ((port_fn("pairs"), tatt.fused_attention_pairs),
                        (port_fn("qkv"), tatt.fused_qkv_attention_pairs)):
        before = counter.launches
        with pytest.raises(ValueError, match="no kernel"):
            if counter is tatt.fused_qkv_attention_pairs:
                fn(q, torch.zeros(C, 3 * C, device="meta"), None)
            else:
                fn(q, k, v)
        assert counter.launches == before
