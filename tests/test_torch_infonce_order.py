"""The arithmetic order of K4's kernels (``csrc/infonce.cu``) up to
B = 256, one thread-block cluster, emulated in plain PyTorch on the CPU and
held against the JAX package's Pallas ``fused_infonce_with_metrics``
(interpret mode, as tests/test_ops.py runs it) and against the port's
plain versions (``infonce_reference``, ``infonce_backward_reference``).

What the emulation follows:
- products as three TF32 products (``csrc/mma_tf32.cuh``): each element
  split into hi = x's top 19 bits (TF32, truncated, as the tensor core
  reads an f32 operand) and lo = x - hi, read the same way; K in steps of
  8 in order, per step corr += lo_a hi_b, corr +=
  hi_a lo_b, main += hi_a hi_b, each mma's eight products summed exactly
  and rounded once into f32; logits = s (main + corr), d_img = s (main +
  corr) of D . txt, d_txt likewise of D^T . img (K = B, zero-padded);
- a tile's statistics (T = 32 up to B = 128, else 64): each row's (and
  column's) valid values in runs of T / (256 / T) per thread, the run's max,
  then sum e and sum e (l - max) in order, the runs merged pairwise
  (first with second, ...: the shuffle tree as lane 0 of a line sees it);
- each row's and column's statistics merged over the tiles in order, its
  cross-entropy, accuracy (ties count) and entropy added by one thread of
  its block, the block's 256 values summed in a pairwise tree, the blocks'
  sums added in rank order; d(neg_log_temp) from each thread's sum of
  D l over the elements e, e + 256, ... of its tile, a tree, the blocks in
  order.
The emulation is a test helper; no model path calls it.

Gates: chip_smoke.py phase 2e's: loss relative error <= 1e-5, LSEs within
1e-5, accuracies equal, entropies within rtol 1e-4, gradients within
atol 1e-4 and rtol 1e-3.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.ops import infonce as jinfonce
from multimodal_baby_tpu_torch.ops import infonce

NLT = float(np.log(1 / 0.07))
THREADS = 256
G = 0.7  # the loss's cotangent


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The tensor core's reading of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] . b [K, N] in the kernels' order (K zero-padded to 8)."""
    K = a.shape[1]
    pad = -K % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = truncate(a), truncate(b)
    al, bl = truncate(a - ah), truncate(b - bh)
    main = torch.zeros(a.shape[0], b.shape[1])
    corr = torch.zeros_like(main)

    def mma(acc, x, y):
        return (acc.double() + x.double() @ y.double()).float()

    for k in range(0, K + pad, 8):
        s = slice(k, k + 8)
        corr = mma(corr, al[:, s], bh[s])
        corr = mma(corr, ah[:, s], bl[s])
        main = mma(main, ah[:, s], bh[s])
    return main + corr


def merge(a, b):
    """(m, s, w) of two runs (f32 tensors); s == 0 marks an empty run."""
    am, as_, aw = a
    bm, bs, bw = b
    m = torch.maximum(am, bm)
    ea = torch.exp(torch.where(as_ > 0, am - m, torch.zeros_like(m)))
    eb = torch.exp(torch.where(bs > 0, bm - m, torch.zeros_like(m)))
    out = (m, as_ * ea + bs * eb,
           ea * (aw + (am - m) * as_) + eb * (bw + (bm - m) * bs))
    out = tuple(torch.where(bs == 0, x, o) for x, o in zip(a, out))
    return tuple(torch.where(as_ == 0, y, o) for y, o in zip(b, out))


def line_stats(lines: torch.Tensor, n: int, T: int):
    """Statistics of the first n values of each line of lines [T, T]."""
    tpl = THREADS // T
    run = T // tpl
    runs = []
    for r in range(tpl):
        c0, c1 = r * run, min(r * run + run, n)
        if c0 >= c1:
            runs.append((torch.full((T,), -math.inf), torch.zeros(T),
                         torch.zeros(T)))
            continue
        x = lines[:, c0:c1]
        mx = x.max(1).values
        s = torch.zeros(T)
        w = torch.zeros(T)
        for c in range(c1 - c0):
            d = x[:, c] - mx
            e = torch.exp(d)
            s = s + e
            w = (e.double() * d.double() + w.double()).float()  # fmaf
        runs.append((mx, s, w))
    while len(runs) > 1:  # the shuffle tree, as lane 0 of a line sees it
        runs = [merge(runs[i], runs[i + 1]) for i in range(0, len(runs), 2)]
    return runs[0]


def tree(v: torch.Tensor) -> torch.Tensor:
    """A block's pairwise sum of its 256 threads' values [256, ...]."""
    n = THREADS // 2
    while n:
        v = v[:n] + v[n:2 * n]
        n //= 2
    return v[0]


def kernel_order_forward(img, txt, nlt):
    B, E = img.shape
    T = 32 if B <= 128 else 64
    nt = -(-B // T)
    scale = torch.exp(torch.tensor(nlt, dtype=torch.float32))
    logits = scale * product_3xtf32(img, txt.T)
    lp = torch.nn.functional.pad(logits, (0, nt * T - B, 0, nt * T - B))
    stats = {}
    for bi in range(nt):
        for bj in range(nt):
            tile = lp[bi * T:(bi + 1) * T, bj * T:(bj + 1) * T]
            rows, cols = min(T, B - bi * T), min(T, B - bj * T)
            stats[bi, bj] = (line_stats(tile, cols, T),
                             line_stats(tile.T.contiguous(), rows, T))
    lse = [torch.zeros(B), torch.zeros(B)]
    sums = []
    for rank in range(nt * nt):
        bi, bj = divmod(rank, nt)
        lo, hi = bj * T // nt, (bj + 1) * T // nt
        v = torch.zeros(THREADS, 6)
        items = hi - lo
        for t in range(2 * items):
            side, r = divmod(t, items)
            idx = bi * T + lo + r
            if idx >= B:
                continue
            st = None
            for x in range(nt):
                one = stats[(x, bi) if side else (bi, x)][side]
                one = tuple(q[lo + r:lo + r + 1] for q in one)
                st = one if st is None else merge(st, one)
            m, s, w = (q[0] for q in st)
            l_ii = logits[idx, idx]
            log_s = torch.log(s)
            lse[side][idx] = m + log_s
            v[t, side] = lse[side][idx] - l_ii
            v[t, 2 + side] = float(l_ii >= m)
            v[t, 4 + side] = log_s - w / s
        sums.append(tree(v))
    tot = torch.zeros(6)
    for s in sums:
        tot = tot + s
    loss = (tot[0] + tot[1]) / (2 * B)
    return loss, lse[0], lse[1], tot[2:] / B, logits


def kernel_order_backward(img, txt, nlt, lse_i, lse_t, logits):
    B, E = img.shape
    T = 32 if B <= 128 else 64
    nt = -(-B // T)
    scale = torch.exp(torch.tensor(nlt, dtype=torch.float32))
    coef = torch.tensor(G, dtype=torch.float32) / (2 * B)
    eye = 2.0 * torch.eye(B)
    D = coef * ((torch.exp(logits - lse_i[:, None])
                 + torch.exp(logits - lse_t[None, :])) - eye)
    dp = torch.nn.functional.pad(D, (0, nt * T - B, 0, nt * T - B))
    lg = torch.nn.functional.pad(logits, (0, nt * T - B, 0, nt * T - B))
    dnlt = torch.zeros(())
    for rank in range(nt * nt):  # each thread's elements e, e + 256, ...
        bi, bj = divmod(rank, nt)
        sl = (slice(bi * T, (bi + 1) * T), slice(bj * T, (bj + 1) * T))
        d, l = dp[sl].reshape(-1), lg[sl].reshape(-1)
        v = torch.zeros(THREADS)
        for k in range(0, T * T, THREADS):
            v = (d[k:k + THREADS].double() * l[k:k + THREADS].double()
                 + v.double()).float()
        dnlt = dnlt + tree(v)
    return (scale * product_3xtf32(D, txt), scale * product_3xtf32(D.T, img),
            dnlt)


def features(B, E, seed):
    rng = np.random.RandomState(seed)
    return tuple(x / np.linalg.norm(x, axis=1, keepdims=True)
                 for x in rng.randn(2, B, E).astype(np.float32))


@pytest.mark.parametrize("E", [32, 68])
@pytest.mark.parametrize("B", [16, 72, 128])
def test_kernel_order_matches_jax_and_the_plain_versions(B, E):
    torch.set_num_threads(1)
    img, txt = features(B, E, B + E)
    ti, tt = torch.from_numpy(img), torch.from_numpy(txt)
    loss, lse_i, lse_t, metrics, logits = kernel_order_forward(ti, tt, NLT)
    grads = kernel_order_backward(ti, tt, NLT, lse_i, lse_t, logits)

    j = (jnp.asarray(img), jnp.asarray(txt), jnp.asarray(NLT, jnp.float32))
    j_loss, (j_lse_i, j_lse_t, j_m) = jinfonce._fused_forward(*j)
    j_grads = jax.grad(lambda i, t, n: G * jinfonce.fused_infonce(i, t, n),
                       argnums=(0, 1, 2))(*j)
    nlt = torch.tensor(NLT)
    p_loss, p_lse_i, p_lse_t, p_m = infonce.infonce_reference(ti, tt, nlt)
    p_grads = infonce.infonce_backward_reference(
        ti, tt, nlt, p_lse_i, p_lse_t, torch.tensor(G))
    wants = {
        "jax": (float(j_loss), np.array(j_lse_i)[:, 0],
                np.array(j_lse_t)[:, 0], np.array(j_m)[0],
                [np.array(x) for x in j_grads]),
        "plain": (float(p_loss), p_lse_i.numpy(), p_lse_t.numpy(),
                  p_m.numpy(), [x.numpy() for x in p_grads])}
    for who, (w_loss, w_lse_i, w_lse_t, w_m, w_grads) in wants.items():
        assert abs(float(loss) - w_loss) <= 1e-5 * abs(w_loss), who
        np.testing.assert_allclose(lse_i.numpy(), w_lse_i, rtol=0,
                                   atol=1e-5, err_msg=who)
        np.testing.assert_allclose(lse_t.numpy(), w_lse_t, rtol=0,
                                   atol=1e-5, err_msg=who)
        np.testing.assert_array_equal(metrics[:2].numpy(), w_m[:2],
                                      err_msg=who)
        np.testing.assert_allclose(metrics[2:].numpy(), w_m[2:], rtol=1e-4,
                                   atol=0, err_msg=who)
        for name, g, w in zip(("d_img", "d_txt", "d_nlt"), grads, w_grads):
            np.testing.assert_allclose(g.numpy(), np.reshape(w, g.shape),
                                       atol=1e-4, rtol=1e-3,
                                       err_msg=f"{who} {name}")
