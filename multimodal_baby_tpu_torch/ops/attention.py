"""The ViT attention kernels of the PyTorch port, each beside its plain
version. Counterparts of ``multimodal_baby_tpu/ops/attention.py``:

- K5 ``fused_block_attention`` (``block_attention_reference``): the whole
  attention half ``x + proj(attention(qkv(LayerNorm(x))))`` on ``x [B, N,
  C]`` with ``wqkv [C, 3C]`` (columns ordered (q | k | v) x (head,
  feature)) and ``wproj [C, C]``, the JAX package's ``[in, out]`` layout;
  the deferred softmax (divide after the value contraction), kernel in
  ``csrc/vit.cu``;
- K8a ``fused_attention`` (``attention_reference``): softmax(q k^T scale)
  v on the heads-first layout ``[B*H, N, d]``, p kept in f32;
- K8b ``fused_attention_pairs`` (``attention_pairs_reference``): the same
  on the token-major layout ``[B, N, C]`` (q, k and v may be the column
  slices of one ``[B, N, 3C]`` tensor), p rounded to the input dtype
  before the value contraction;
- K8c ``fused_qkv_attention_pairs`` (``qkv_attention_pairs_reference``):
  the qkv projection inside, then K8b.

K8a-c divide by the row sum before the value contraction, as the TPU
kernels do; their kernels are in ``csrc/attention.cu``. Each wrapper runs
its kernel on a CUDA tensor and its plain version on a CPU tensor; the
gradient is the plain version's VJP. ``should_fuse_*`` are the JAX
package's shape gates, which the ViT's dispatch follows.

Not carried over: the ``MMB_ATTN_SMAX`` and ``MMB_VIT_BLOCK_BM``
environment knobs, and the TPU kernels' two-heads-per-128-lanes packing
(the +/- score trick), which only fills the TPU's 128-wide contraction.
"""

from __future__ import annotations

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.vit_common import (
    PlainVJP, check_args, layer_norm)

__all__ = ["attention_pairs_reference", "attention_reference",
           "block_attention_reference", "fused_attention",
           "fused_attention_pairs", "fused_block_attention",
           "fused_qkv_attention_pairs", "qkv_attention_pairs_reference",
           "should_fuse_attention", "should_fuse_attention_pairs",
           "should_fuse_block_attention", "should_fuse_qkv_attention_pairs"]

HEAD_DIM = 64      # the kernels' head width
MAX_TOKENS = 752   # K and V of one head for N tokens fit in shared memory
MAX_TOKENS_QKV = 416  # K8c: q, k and v of one head in shared memory


# ------------------------------------------------ the JAX package's gates

def should_fuse_attention(n_tokens: int, head_dim: int) -> bool:
    """K8a's gate: the TPU kernel's VMEM budget (scores + q/k/v/out)."""
    working = (n_tokens * n_tokens + 4 * n_tokens * head_dim) * 4
    return working < 12 * 1024 * 1024


def should_fuse_attention_pairs(n_tokens: int, num_heads: int,
                                head_dim: int) -> bool:
    """K8b's gate: heads of 64, an even head count, the VMEM budget."""
    if head_dim != 64 or num_heads % 2:
        return False
    working = (4 * n_tokens * num_heads * head_dim * 2
               + 6 * n_tokens * n_tokens * 4)
    return working < 48 * 1024 * 1024


def should_fuse_qkv_attention_pairs(n_tokens: int, num_heads: int,
                                    head_dim: int) -> bool:
    """K8c's gate: K8b's plus the resident [C, 3C] weight block."""
    if not should_fuse_attention_pairs(n_tokens, num_heads, head_dim):
        return False
    C = num_heads * head_dim
    return 3 * C * C * 2 < 16 * 1024 * 1024


def should_fuse_block_attention(n_tokens: int, num_heads: int,
                                head_dim: int) -> bool:
    """K5's gate: K8c's plus the resident [C, C] proj block."""
    if not should_fuse_qkv_attention_pairs(n_tokens, num_heads, head_dim):
        return False
    C = num_heads * head_dim
    return (3 * C * C + C * C) * 2 < 20 * 1024 * 1024


# --------------------------------------------------------- plain versions

def _key_mask(s: torch.Tensor, kv_valid: int | None) -> torch.Tensor:
    """-1e9 added at key columns >= kv_valid (exp of it is exactly 0)."""
    N = s.shape[-1]
    n_keys = N if kv_valid is None else min(kv_valid, N)
    if n_keys < N:
        col = torch.arange(N, device=s.device)
        s = s + torch.where(col < n_keys, 0.0, -1e9).to(s.dtype)
    return s


def _softmax(s: torch.Tensor, kv_valid: int | None) -> torch.Tensor:
    """The TPU kernels' exact softmax in f32: p = exp(s - max) / sum."""
    s = _key_mask(s, kv_valid)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, kv_valid: int | None = None
                        ) -> torch.Tensor:
    """K8a in plain PyTorch (``_attn_kernel``): q, k, v ``[B*H, N, d]``
    taken to f32; s = (q . k) * scale with -1e9 at key columns >=
    kv_valid; p = exp(s - max) / sum in f32; (p . v) rounded to q's
    dtype."""
    f32 = torch.float32
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
    return (_softmax(s, kv_valid) @ v.to(f32)).to(q.dtype)


def attention_pairs_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int, scale: float,
                              kv_valid: int | None = None) -> torch.Tensor:
    """K8b in plain PyTorch (``_attn_pairs_kernel``): q, k, v ``[B, N, C]``
    with columns ordered (head, feature); per head s = (q . k) * scale in
    f32 with -1e9 at key columns >= kv_valid; p = exp(s - max) / sum,
    rounded to q's dtype; (p . v) in f32, rounded to q's dtype."""
    dt = q.dtype
    f32 = torch.float32
    B, N, C = q.shape
    q, k, v = (t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)
               .to(f32) for t in (q, k, v))                # [B, H, N, d]
    p = _softmax((q @ k.transpose(-1, -2)) * scale, kv_valid)
    y = p.to(dt).to(f32) @ v
    return y.transpose(1, 2).reshape(B, N, C).to(dt)


def qkv_attention_pairs_reference(x: torch.Tensor, wqkv: torch.Tensor,
                                  bqkv: torch.Tensor | None, num_heads: int,
                                  scale: float, kv_valid: int | None = None
                                  ) -> torch.Tensor:
    """K8c in plain PyTorch (``_qkv_attn_pairs_kernel``): q, k, v =
    round(round(x . wqkv) + bqkv) in x's dtype (the product rounded, then
    the bias added and the sum rounded, as nn.Dense in bf16), then
    ``attention_pairs_reference``."""
    dt = x.dtype
    C = x.shape[-1]
    qkv = (x.to(torch.float32) @ wqkv.to(dt).to(torch.float32)).to(dt)
    if bqkv is not None:
        qkv = qkv + bqkv.to(dt)
    return attention_pairs_reference(qkv[..., :C], qkv[..., C:2 * C],
                                     qkv[..., 2 * C:], num_heads, scale,
                                     kv_valid)


def block_attention_reference(x: torch.Tensor, ln_scale: torch.Tensor,
                              ln_bias: torch.Tensor, wqkv: torch.Tensor,
                              bqkv: torch.Tensor, wproj: torch.Tensor,
                              bproj: torch.Tensor, num_heads: int,
                              scale: float, kv_valid: int | None = None,
                              eps: float = 1e-6) -> torch.Tensor:
    """The attention half in plain PyTorch with the kernel's rounding points
    (``_attn_half_f32``): LayerNorm rounded to ``x.dtype``; q, k, v =
    round(round(xn . wqkv) + bqkv); scores (q . k) * scale in f32 with
    -1e9 added at key columns >= kv_valid; p = exp(s - max) in f32, z =
    sum(p) from the unrounded p, p rounded; y = round((p . v) * (1 / z));
    the residual sum ``x + y . wproj + bproj`` in f32, rounded once. The
    parameters are used in ``x.dtype``, as the JAX wrapper casts them."""
    dt = x.dtype
    f32 = torch.float32
    B, N, C = x.shape
    d = C // num_heads
    xn = layer_norm(x, ln_scale.to(dt), ln_bias.to(dt), eps)
    qkv = (xn.to(f32) @ wqkv.to(dt).to(f32)).to(dt) + bqkv.to(dt)
    q, k, v = (t.reshape(B, N, num_heads, d).transpose(1, 2).to(f32)
               for t in qkv.split(C, dim=-1))                  # [B, H, N, d]
    s = _key_mask((q @ k.transpose(-1, -2)) * scale, kv_valid)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    z = p.sum(-1, keepdim=True)
    y = ((p.to(dt).to(f32) @ v) * (1.0 / z)).to(dt)
    y = y.transpose(1, 2).reshape(B, N, C)
    out = y.to(f32) @ wproj.to(dt).to(f32)
    return (x.to(f32) + out + bproj.to(dt).to(f32)).to(dt)


def n_keys_checked(what: str, N: int, kv_valid: int | None,
                   max_tokens: int) -> int:
    """The keys a kernel attends to, min(kv_valid, N); raises ValueError
    unless 1 <= that <= N <= max_tokens."""
    if not 1 <= N <= max_tokens:
        raise ValueError(f"{what}: needs 1 <= N <= {max_tokens}; got N={N}")
    n_keys = N if kv_valid is None else min(kv_valid, N)
    if n_keys < 1:
        raise ValueError(f"{what}: kv_valid={kv_valid} < 1")
    return n_keys


def _run(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale,
         kv_valid, eps):
    if x.device.type == "cpu":
        return block_attention_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wproj, bproj, num_heads, scale,
                                         kv_valid, eps)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_block_attention: no kernel for device {x.device}")
    B, N, C = x.shape
    check_args("fused_block_attention", x, {
        "ln_scale": (ln_scale, (C,)), "ln_bias": (ln_bias, (C,)),
        "wqkv": (wqkv, (C, 3 * C)), "bqkv": (bqkv, (3 * C,)),
        "wproj": (wproj, (C, C)), "bproj": (bproj, (C,))})
    if C % 128 or num_heads * HEAD_DIM != C:
        raise ValueError(
            f"fused_block_attention: needs C % 128 == 0 and heads of "
            f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    n_keys = n_keys_checked("fused_block_attention", N, kv_valid, MAX_TOKENS)
    lib = _build.library()
    xn = torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.mmb_vit_attention_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), xn.data_ptr(), qkv.data_ptr(), y.data_ptr(),
            out.data_ptr(), B, N, C, n_keys, scale, eps,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_block_attention")
    fused_block_attention.launches += 1
    return out


def fused_block_attention(x: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, wqkv: torch.Tensor,
                          bqkv: torch.Tensor, wproj: torch.Tensor,
                          bproj: torch.Tensor, num_heads: int, scale: float,
                          kv_valid: int | None = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """``x + proj(attention(qkv(LayerNorm(x))))`` with the parameters cast
    to ``x.dtype``; key columns >= ``kv_valid`` are masked. On a CUDA
    tensor this launches the Hopper kernel (bf16, heads of 64, C a multiple
    of 128, N <= 752, every tensor contiguous) and raises on anything it
    cannot take; it never falls back. On a CPU tensor it runs
    ``block_attention_reference``. The gradient is the VJP of
    ``block_attention_reference``. ``fused_block_attention.launches``
    counts kernel launches."""
    dt = x.dtype
    params = [t.to(dt) for t in (ln_scale, ln_bias, wqkv, bqkv, wproj,
                                 bproj)]
    return PlainVJP.apply(_run, block_attention_reference,
                          (num_heads, scale, kv_valid, eps), x, *params)


fused_block_attention.launches = 0


# ------------------------------------------------------------- K8a, K8b

def _launch_attention(what, q, k, v, y, images, heads, n_keys, scale, split):
    """The K8a/K8b kernel on [images, N, *] views whose head h is columns
    64h .. 64h + 63 (strides in elements)."""
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.mmb_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), y.stride(0),
            q.stride(1), k.stride(1), v.stride(1), y.stride(1),
            images, heads, q.shape[1], n_keys, scale, int(split),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, what)


def _run_attention(q, k, v, scale, kv_valid):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    BH, N, d = q.shape
    check_args("fused_attention", q, {"k": (k, (BH, N, d)),
                                      "v": (v, (BH, N, d))}, strided=True)
    if d != HEAD_DIM:
        raise ValueError(f"fused_attention: needs heads of {HEAD_DIM}, got "
                         f"d={d}")
    n_keys = n_keys_checked("fused_attention", N, kv_valid, MAX_TOKENS)
    y = torch.empty((BH, N, d), dtype=q.dtype, device=q.device)
    _launch_attention("fused_attention", q, k, v, y, BH, 1, n_keys, scale,
                      True)
    fused_attention.launches += 1
    return y


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, kv_valid: int | None = None
                    ) -> torch.Tensor:
    """K8a: softmax(q k^T scale) v per (image, head) on q, k, v ``[B*H, N,
    d]``, key columns >= ``kv_valid`` masked, p kept at f32 grade. On a
    CUDA tensor this launches the Hopper kernel (bf16, d = 64, N <= 752,
    a contiguous last axis) and raises on anything it cannot take; on a
    CPU tensor it runs ``attention_reference``. The gradient is the VJP of
    ``attention_reference``. ``fused_attention.launches`` counts kernel
    launches."""
    return PlainVJP.apply(_run_attention, attention_reference,
                          (scale, kv_valid), q, k, v)


def _run_attention_pairs(q, k, v, num_heads, scale, kv_valid):
    if q.device.type == "cpu":
        return attention_pairs_reference(q, k, v, num_heads, scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(
            f"fused_attention_pairs: no kernel for device {q.device}")
    B, N, C = q.shape
    check_args("fused_attention_pairs", q, {"k": (k, (B, N, C)),
                                            "v": (v, (B, N, C))},
               strided=True)
    if num_heads * HEAD_DIM != C:
        raise ValueError(f"fused_attention_pairs: needs heads of {HEAD_DIM};"
                         f" got C={C}, heads={num_heads}")
    n_keys = n_keys_checked("fused_attention_pairs", N, kv_valid, MAX_TOKENS)
    y = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    _launch_attention("fused_attention_pairs", q, k, v, y, B, num_heads,
                      n_keys, scale, False)
    fused_attention_pairs.launches += 1
    return y


def fused_attention_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float,
                          kv_valid: int | None = None) -> torch.Tensor:
    """K8b: multi-head attention on the token-major layout: q, k, v ``[B,
    N, C]`` (columns (head, feature); views such as the column slices of
    one qkv tensor are taken as they are), key columns >= ``kv_valid``
    masked, p rounded to the input dtype before the value contraction. On
    a CUDA tensor this launches the Hopper kernel (bf16, heads of 64, N <=
    752) and raises on anything it cannot take; on a CPU tensor it runs
    ``attention_pairs_reference``. The gradient is the VJP of
    ``attention_pairs_reference``. ``fused_attention_pairs.launches``
    counts kernel launches."""
    return PlainVJP.apply(_run_attention_pairs, attention_pairs_reference,
                          (num_heads, scale, kv_valid), q, k, v)


# ------------------------------------------------------------------ K8c

def _run_qkv_attention_pairs(x, wqkv, bqkv, num_heads, scale, kv_valid):
    if x.device.type == "cpu":
        return qkv_attention_pairs_reference(x, wqkv, bqkv, num_heads, scale,
                                             kv_valid)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_qkv_attention_pairs: no kernel for device {x.device}")
    B, N, C = x.shape
    check_args("fused_qkv_attention_pairs", x, {
        "wqkv": (wqkv, (C, 3 * C)), "bqkv": (bqkv, (3 * C,))})
    if num_heads * HEAD_DIM != C:
        raise ValueError(f"fused_qkv_attention_pairs: needs heads of "
                         f"{HEAD_DIM}; got C={C}, heads={num_heads}")
    n_keys = n_keys_checked("fused_qkv_attention_pairs", N, kv_valid,
                     MAX_TOKENS_QKV)
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.mmb_qkv_attention_bf16(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), y.data_ptr(),
            B, N, C, n_keys, scale, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_qkv_attention_pairs")
    fused_qkv_attention_pairs.launches += 1
    return y


def fused_qkv_attention_pairs(x: torch.Tensor, wqkv: torch.Tensor,
                              bqkv: torch.Tensor | None, num_heads: int,
                              scale: float, kv_valid: int | None = None
                              ) -> torch.Tensor:
    """K8c: the qkv projection (``wqkv [C, 3C]``, ``bqkv [3C]`` or None)
    and K8b in one kernel on the (LayerNormed) ``x [B, N, C]``: the [B, N,
    3C] qkv tensor never reaches device memory. The parameters are cast to
    ``x.dtype``. On a CUDA tensor this launches the Hopper kernel (bf16,
    heads of 64, N <= 416, contiguous tensors) and raises on anything it
    cannot take; on a CPU tensor it runs ``qkv_attention_pairs_reference``.
    The gradient is the VJP of ``qkv_attention_pairs_reference``.
    ``fused_qkv_attention_pairs.launches`` counts kernel launches."""
    dt = x.dtype
    C = x.shape[-1]
    bqkv = (torch.zeros(3 * C, dtype=dt, device=x.device) if bqkv is None
            else bqkv.to(dt))
    return PlainVJP.apply(_run_qkv_attention_pairs,
                          qkv_attention_pairs_reference,
                          (num_heads, scale, kv_valid), x, wqkv.to(dt), bqkv)


fused_attention.launches = 0
fused_attention_pairs.launches = 0
fused_qkv_attention_pairs.launches = 0
