"""The arithmetic order of the K5, K8a, K8b and K8c kernels
(``csrc/attn_mma.cuh``) emulated in plain PyTorch, held against the JAX
package's Pallas kernels (interpret mode, as tests/test_ops.py runs them)
and against the port's plain versions; and the kernels' launch geometry
(``ops/attention.py::attention_geometry``) for every N they accept.

The kernels rewrite the TPU kernels' softmax in two ways that move p by a
few ulp: exp(s scale - m) becomes exp2(s c - m') with c = scale log2(e)
folded into the score (in f32), and p = e * (1 / z) with one reciprocal per
row. Rows longer than one chunk of registers (np > 272) take two passes:
the max and the sum carried online from chunk to chunk (z = z exp2(m -
m_new) + sum exp2(s c - m_new)), then p recomputed chunk by chunk. K8a
keeps p at f32 grade as bf16(p) + bf16(p - bf16(p)) against the bf16 V;
K8b rounds p to bf16 into one value product, reading q, k and v in place
(column slices of the qkv tensor); K8c rounds p the same way and projects
q, k, v = bf16(bf16(x W) + b). K8b launches with K8a's geometry. K5 (the
attention half, ``fused_block_attention``) runs the same core in its
deferred mode with K8b's geometry, between its LayerNorm and qkv Dense and
its proj Dense: e = exp2(s c - m') with the launch geometry's one- or
two-pass statistics, z summed from the unrounded e, bf16(e) into one value
product, y = bf16((bf16(e) v) (1 / z)). The emulations are test helpers;
no model path calls them.

Gate: phase 2d's (chip_smoke.py), max error relative to the largest output
<= 1e-2 and cosine >= 0.9999. Observed: rel at most 6.5e-3 (K8a at N =
257, kv_valid = 252: one bf16 ulp of an output near the largest; K8c at
most 2.8e-3), cosine 1.0000000 to seven digits in every case: a margin of
1.5x on the relative error. K8a's emulation is also held to the
f32 result within K8a's card test bound (tests/test_torch_cuda.py): one
bf16 rounding plus 2e-5 of max |v|. K5's emulation is held to the same
gate (rel <= 1e-2, cos >= 0.9999) against the JAX package's Pallas
``fused_block_attention`` (its default deferred softmax) and against the
port's ``block_attention_reference``: observed rel at most 3.9e-3 (N =
257, kv_valid = 252), cosine 1.0000000 to seven digits, 0 to 33 of the
bf16 outputs moved by a rounding.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import attention as jatt
from multimodal_baby_tpu_torch.ops import attention as tatt
from multimodal_baby_tpu_torch.ops.vit_common import layer_norm

D = 64
SCALE = D ** -0.5
REL_TOL = 1e-2
COS_TOL = 0.9999
# N = 17 and 257 (one chunk), and 400 (two chunks: the two-pass order)
LENGTHS = [17, 257, 400]


def kernel_order_attention(q, k, v, scale, kv_valid, split, defer=False):
    """softmax(q k^T scale) v on [BH, N, 64] in the kernels' order: f32
    scores, exp2 of the folded score, the online chunk statistics of the
    launch geometry, p = e * (1 / z); split: p as bf16 hi + lo against V
    (K8a), else p rounded to bf16 (K8c); defer (K5): bf16(e) against V,
    the product times 1 / z. Returns q's dtype."""
    f32 = torch.float32
    N = q.shape[1]
    geo = tatt.attention_geometry(N)
    n_keys = N if kv_valid is None else kv_valid
    s = q.to(f32) @ k.to(f32).transpose(-1, -2)
    c = (torch.tensor(scale, dtype=f32)
         * torch.tensor(math.log2(math.e), dtype=f32))
    col = torch.arange(N)
    s = torch.where(col < n_keys, s * c, torch.tensor(-math.inf))
    bounds = [(i * geo.kc, min((i + 1) * geo.kc, N))
              for i in range(geo.nchunks)]
    bounds = [(a, b) for a, b in bounds if a < N]  # pad keys: exp2 = 0
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    z = torch.zeros_like(m)
    for a, b in bounds:
        mn = torch.maximum(m, s[..., a:b].amax(-1, keepdim=True))
        add = torch.exp2(s[..., a:b] - mn).sum(-1, keepdim=True)
        z = z * torch.exp2(m - mn) + add
        m = mn
    e = torch.exp2(s - m)
    if defer:
        o = e.to(torch.bfloat16).to(f32) @ v.to(f32)
        return (o * (1.0 / z)).to(q.dtype)
    p = e * (1.0 / z)
    hi = p.to(torch.bfloat16).to(f32)
    o = hi @ v.to(f32)
    if split:
        o = o + (p - hi).to(torch.bfloat16).to(f32) @ v.to(f32)
    return o.to(q.dtype)


def kernel_order_pairs_attention(q, k, v, heads, scale, kv_valid):
    """K8b: the attention with p in bf16 on q, k, v [B, N, C] as given
    (strided views included), heads side by side."""
    B, N, C = q.shape

    def heads_first(t):
        return t.reshape(B, N, heads, D).transpose(1, 2).reshape(-1, N, D)

    y = kernel_order_attention(*map(heads_first, (q, k, v)), scale,
                               kv_valid, split=False)
    return y.reshape(B, heads, N, D).transpose(1, 2).reshape(B, N, C)


def kernel_order_qkv_attention(x, w, b, heads, scale, kv_valid):
    """K8c: q, k, v = bf16(bf16(x w) + b), then the attention with p in
    bf16, on x [B, N, C]."""
    dt = x.dtype
    B, N, C = x.shape
    qkv = (x.float() @ w.float()).to(dt) + b.to(dt)

    def heads_first(t):
        return t.reshape(B, N, heads, D).transpose(1, 2).reshape(-1, N, D)

    q, k, v = map(heads_first, qkv.split(C, -1))
    y = kernel_order_attention(q, k, v, scale, kv_valid, split=False)
    return y.reshape(B, heads, N, D).transpose(1, 2).reshape(B, N, C)


def kernel_order_block_attention(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj,
                                 heads, scale, kv_valid, eps=1e-6):
    """K5 on x [B, N, C]: the LayerNorm (``layer_norm``'s order), q, k, v
    = bf16(bf16(xn wqkv) + bqkv), the deferred attention in the kernel's
    order, then bf16(x + y wproj + bproj) summed in f32."""
    dt = x.dtype
    f32 = torch.float32
    B, N, C = x.shape
    xn = layer_norm(x, ln_g.to(dt), ln_b.to(dt), eps)
    qkv = (xn.to(f32) @ wqkv.to(dt).to(f32)).to(dt) + bqkv.to(dt)

    def heads_first(t):
        return t.reshape(B, N, heads, D).transpose(1, 2).reshape(-1, N, D)

    q, k, v = map(heads_first, qkv.split(C, -1))
    y = kernel_order_attention(q, k, v, scale, kv_valid, split=False,
                               defer=True)
    y = y.reshape(B, heads, N, D).transpose(1, 2).reshape(B, N, C)
    out = y.to(f32) @ wproj.to(dt).to(f32)
    return (x.to(f32) + out + bproj.to(dt).to(f32)).to(dt)


def gate(got, want):
    got, want = got.double().flatten(), want.double().flatten()
    rel = float((got - want).abs().max() / want.abs().max())
    cos = float(got @ want / (got.norm() * want.norm()))
    assert rel <= REL_TOL and cos >= COS_TOL, (rel, cos)


def bf16_operands(rng, *shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        torch.bfloat16) for s in shapes]


def to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("kv_off", [None, 5])
@pytest.mark.parametrize("N", LENGTHS)
def test_k8a_order_matches_pallas_and_plain(N, kv_off):
    kv = None if kv_off is None else N - kv_off
    q, k, v = bf16_operands(np.random.RandomState(N), *[(2, N, D)] * 3)
    got = kernel_order_attention(q, k, v, SCALE, kv, split=True)
    want_jax = torch.from_numpy(np.array(jatt.fused_attention(
        to_jax(q), to_jax(k), to_jax(v), SCALE, kv).astype(jnp.float32)))
    gate(got, want_jax)
    gate(got, tatt.attention_reference(q, k, v, SCALE, kv))
    # p at f32 grade: within one bf16 rounding of the f32 result, give or
    # take 2e-5 of max |v|
    exact = tatt.attention_reference(q.float(), k.float(), v.float(), SCALE,
                                     kv)
    slack = (got.float() - exact).abs() - 2 ** -8 * exact.abs()
    assert float(slack.max()) <= 2e-5 * float(v.float().abs().max())


@pytest.mark.parametrize("kv_off", [None, 5])
@pytest.mark.parametrize("N", LENGTHS)
def test_k8b_order_matches_pallas_and_plain(N, kv_off):
    """On q, k, v taken as column slices of one [B, N, 3C] tensor (row
    stride 3C), as the ViT's attn=pairs path passes them."""
    kv = None if kv_off is None else N - kv_off
    C, heads = 128, 2
    qkv, = bf16_operands(np.random.RandomState(N + 2), (2, N, 3 * C))
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    assert q.stride(1) == 3 * C and not q.is_contiguous()
    got = kernel_order_pairs_attention(q, k, v, heads, SCALE, kv)
    want_jax = torch.from_numpy(np.array(jatt.fused_attention_pairs(
        to_jax(q), to_jax(k), to_jax(v), heads, SCALE, kv).astype(
            jnp.float32)))
    gate(got, want_jax)
    gate(got, tatt.attention_pairs_reference(q, k, v, heads, SCALE, kv))


@pytest.mark.parametrize("kv_off", [None, 5])
@pytest.mark.parametrize("N", LENGTHS)
def test_k8c_order_matches_pallas_and_plain(N, kv_off):
    kv = None if kv_off is None else N - kv_off
    C, heads = 128, 2
    rng = np.random.RandomState(N + 1)
    x, = bf16_operands(rng, (1, N, C))
    w = torch.from_numpy((rng.randn(C, 3 * C) / np.sqrt(C)).astype(
        np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((0.1 * rng.randn(3 * C)).astype(np.float32)).to(
        torch.bfloat16)
    got = kernel_order_qkv_attention(x, w, b, heads, SCALE, kv)
    want_jax = torch.from_numpy(np.array(jatt.fused_qkv_attention_pairs(
        to_jax(x), to_jax(w), to_jax(b), heads, SCALE, kv).astype(
            jnp.float32)))
    gate(got, want_jax)
    gate(got, tatt.qkv_attention_pairs_reference(x, w, b, heads, SCALE, kv))


@pytest.mark.parametrize("kv_off", [None, 5])
@pytest.mark.parametrize("N", LENGTHS)
def test_k5_order_matches_pallas_and_plain(N, kv_off):
    """The whole attention half at C = 128 with 2 heads (one 128-lane head
    pair in the Pallas kernel)."""
    kv = None if kv_off is None else N - kv_off
    C, heads = 128, 2
    rng = np.random.RandomState(N + 3)
    x, = bf16_operands(rng, (1, N, C))
    params = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
              for a in (1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C),
                        rng.randn(C, 3 * C) / np.sqrt(C),
                        0.1 * rng.randn(3 * C), rng.randn(C, C) / np.sqrt(C),
                        0.1 * rng.randn(C))]
    got = kernel_order_block_attention(x, *params, heads, SCALE, kv)
    want_jax = torch.from_numpy(np.array(jatt.fused_block_attention(
        to_jax(x), *map(to_jax, params), heads, SCALE, kv).astype(
            jnp.float32)))
    gate(got, want_jax)
    gate(got, tatt.block_attention_reference(x, *params, heads, SCALE, kv))


@pytest.mark.parametrize("qkv", [False, True])
def test_geometry_serves_every_length(qkv):
    """For every N the kernels accept (K8a and K8b: qkv False, N <= 752;
    K8c: N <= 416): the chunks are multiples of 16 of at
    most 272 keys and cover np exactly; K and V hold the last chunk's start
    + 272 rows (every chunk is read as 272 keys); shared memory fits a
    block; K8a gives no warp an all-padding slab; one chunk exactly when np
    <= 272."""
    cap = tatt.MAX_TOKENS_QKV if qkv else tatt.MAX_TOKENS
    for N in range(1, cap + 1):
        geo = tatt.attention_geometry(N, qkv=qkv)
        assert geo.np == -(-N // 16) * 16
        assert geo.kc % 16 == 0 and 16 <= geo.kc <= tatt.KEY_CHUNK
        sizes = [min(geo.kc, geo.np - i * geo.kc)
                 for i in range(geo.nchunks)]
        assert min(sizes) > 0 and sum(sizes) == geo.np
        assert (geo.nchunks == 1) == (geo.np <= tatt.KEY_CHUNK)
        assert geo.rows == (geo.nchunks - 1) * geo.kc + tatt.KEY_CHUNK
        assert geo.smem <= tatt.SMEM_LIMIT
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= 128
        if not qkv:
            assert geo.threads // 32 <= geo.np // 16
            assert geo.smem == 4 * geo.rows * D


@pytest.mark.parametrize("N,qkv", [(0, False), (753, False), (0, True),
                                   (417, True)])
def test_geometry_raises_on_lengths_it_cannot_serve(N, qkv):
    with pytest.raises(ValueError):
        tatt.attention_geometry(N, qkv=qkv)
