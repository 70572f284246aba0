"""The arithmetic order of K9's tensor-core kernel (``csrc/lstm.cu``)
emulated in plain PyTorch on the CPU, held against the JAX package's Pallas
``lstm_fused`` (interpret mode, as tests/test_ops.py runs it) and against
the port's ``scan_reference``.

The kernel computes each step's h . W_hh as three TF32 products
(``csrc/mma_tf32.cuh``): every element x of h and of W_hh is split into
hi = x's top 19 bits (TF32, truncated: the tensor core's own reading of
an f32 operand) and lo = x - hi, of which the tensor core again reads the
top 19 bits; K runs in steps of 8 (one m16n8k8 mma each), the steps of
each phase mod 4 in a warp of their own, in order, and per step the small
products go first into their own accumulator (corr += lo_W hi_h, then
corr += hi_W lo_h) and the large one into another (main += hi_W hi_h);
with s_p = main + corr of phase p, pre = x_proj + ((s0 + s1) + (s2 +
s3)). One mma is emulated as
its eight products summed exactly and added to the f32 accumulator with one
rounding. The gates follow in f32. The emulation is a test helper; no model
path calls it.

Gate: 1e-4 max abs error on out, h_last and c_last (chip_smoke.py phase
2e's). The split itself is held tighter: the emulation stays within 2e-6 of
the scan in f64, where one TF32 product a step (the split's first term
alone) is held to be off by more than 10 times that, which is why the
kernel pays for three.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import lstm as jlstm
from multimodal_baby_tpu_torch.ops.lstm import scan_reference

GATE = 1e-4
SPLIT_TOL = 2e-6


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The tensor core's reading of an f32 operand: its top 19 bits (TF32,
    the 13 low mantissa bits dropped)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = truncate(x)
    return hi, truncate(x - hi)


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc [M, N] f32 += a [M, 8] . b [8, N]: the eight products summed
    exactly (f64), one rounding into f32."""
    return (acc.double() + a.double() @ b.double()).float()


def product_3xtf32(h: torch.Tensor, w: torch.Tensor,
                   single: bool = False) -> torch.Tensor:
    """h [B, K] . w [K, N] in the kernel's order: the k steps of each phase
    mod 4 in a warp of their own, in order, per step corr += lo_W hi_h,
    corr += hi_W lo_h, main += hi_W hi_h; with s_p = main + corr of phase
    p, (s0 + s1) + (s2 + s3). ``single``: only the hi . hi term (one TF32
    product)."""
    hh, hl = split(h)
    wh, wl = split(w)
    B, K = h.shape
    sums = []
    for phase in range(4):
        main = torch.zeros(B, w.shape[1])
        corr = torch.zeros_like(main)
        for k in range(8 * phase, K, 32):
            s = slice(k, k + 8)
            if not single:
                corr = mma(corr, hh[:, s], wl[s])   # lo_W hi_h
                corr = mma(corr, hl[:, s], wh[s])   # hi_W lo_h
            main = mma(main, hh[:, s], wh[s])
        sums.append(main + corr)
    return (sums[0] + sums[1]) + (sums[2] + sums[3])


def kernel_order_lstm(xp, mask, whh, h0, c0, single=False):
    """K9's forward in the kernel's arithmetic order (f32 tensors)."""
    H = h0.shape[1]
    h, c = h0, c0
    outs = []
    for t in range(xp.shape[0]):
        pre = xp[t] + product_3xtf32(h, whh, single)
        i, f, g, o = pre.split(H, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outs.append(m * h_new)
    return torch.stack(outs), h, c


def inputs(L, B, H, seed):
    """chip_smoke.py phase 2e's kind of inputs: x_proj of N(0, 1)
    embeddings through U(-1/sqrt(H), 1/sqrt(H)) weights, random lengths."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(H)
    lens = rng.randint(1, L + 1, B)
    lens[0] = L
    emb = rng.randn(L, B, H).astype(np.float32)
    w_ih = rng.uniform(-k, k, (H, 4 * H)).astype(np.float32)
    return {"xp": (emb @ w_ih + rng.uniform(-2 * k, 2 * k, 4 * H)
                   ).astype(np.float32),
            "mask": (np.arange(L)[:, None] < lens[None, :]).astype(
                np.float32),
            "whh": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "h0": (0.1 * rng.randn(B, H)).astype(np.float32),
            "c0": np.zeros((B, H), np.float32)}


@pytest.mark.parametrize("L,B,H", [(64, 8, 64), (25, 37, 48)])
def test_kernel_order_matches_jax_and_the_scan(L, B, H):
    torch.set_num_threads(1)
    a = inputs(L, B, H, seed=L + B + H)
    names = ("xp", "mask", "whh", "h0", "c0")
    got = kernel_order_lstm(*(torch.from_numpy(a[k]) for k in names))
    jax_out = jlstm.lstm_fused(*(jnp.asarray(a[k]) for k in names))
    plain = scan_reference(*(torch.from_numpy(a[k]) for k in names))
    exact = scan_reference(*(torch.from_numpy(a[k]).double() for k in names))
    single = kernel_order_lstm(*(torch.from_numpy(a[k]) for k in names),
                               single=True)
    for n, (g, j, p, e, s1) in enumerate(zip(got, jax_out, plain, exact,
                                              single)):
        name = ("out", "h_last", "c_last")[n]
        g64 = g.double()
        assert float((g64 - torch.from_numpy(np.array(j)).double()
                      ).abs().max()) <= GATE, name
        assert float((g64 - p.double()).abs().max()) <= GATE, name
        err = float((g64 - e).abs().max())
        assert err <= SPLIT_TOL, (name, err)
        if name == "out":
            assert float((s1.double() - e).abs().max()) > 10 * err


def test_tf32_split_keeps_twenty_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -10 + 2.0 ** -11),
                      3.0, 0.0], dtype=torch.float32)
    assert truncate(x).tolist() == [1.0, -(1.0 + 2.0 ** -10), 3.0, 0.0]
    v = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32))
    hi, lo = split(v)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max()
    assert float(rel) < 2.0 ** -19
