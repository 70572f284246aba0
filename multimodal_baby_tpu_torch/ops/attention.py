"""The fused ViT attention half (K5) for the PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/attention.py::
fused_block_attention``: ``x + proj(attention(qkv(LayerNorm(x))))`` on
``x [B, N, C]`` with ``wqkv [C, 3C]`` (columns ordered (q | k | v) x
(head, feature)) and ``wproj [C, C]``, the JAX package's ``[in, out]``
layout. ``fused_block_attention`` runs the hand-written Hopper kernel in
``csrc/vit.cu`` on a CUDA tensor and ``block_attention_reference`` on a
CPU tensor.

Only the JAX default softmax is ported, the deferred form (divide after
the value contraction); the ``MMB_ATTN_SMAX`` and ``MMB_VIT_BLOCK_BM``
environment knobs are not. The TPU kernel's two-heads-per-128-lanes
packing is its own tiling and is not carried over.
"""

from __future__ import annotations

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.vit_common import (
    PlainVJP, check_args, layer_norm)

__all__ = ["block_attention_reference", "fused_block_attention"]

HEAD_DIM = 64      # the kernel's head width
MAX_TOKENS = 752   # K and V of one head for N tokens fit in shared memory


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
    s = (q @ k.transpose(-1, -2)) * scale
    n_keys = N if kv_valid is None else min(kv_valid, N)
    if n_keys < N:
        col = torch.arange(N, device=x.device)
        s = s + torch.where(col < n_keys, 0.0, -1e9).to(f32)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    z = p.sum(-1, keepdim=True)
    y = ((p.to(dt).to(f32) @ v) * (1.0 / z)).to(dt)
    y = y.transpose(1, 2).reshape(B, N, C)
    out = y.to(f32) @ wproj.to(dt).to(f32)
    return (x.to(f32) + out + bproj.to(dt).to(f32)).to(dt)


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
    if C % 128 or num_heads * HEAD_DIM != C or not 1 <= N <= MAX_TOKENS:
        raise ValueError(
            f"fused_block_attention: needs C % 128 == 0, heads of "
            f"{HEAD_DIM} and 1 <= N <= {MAX_TOKENS}; got C={C}, "
            f"heads={num_heads}, N={N}")
    n_keys = N if kv_valid is None else min(kv_valid, N)
    if n_keys < 1:
        raise ValueError(f"fused_block_attention: kv_valid={kv_valid} < 1")
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
