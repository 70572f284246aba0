"""The whole pre-norm ViT block (K7) for the PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/vit_block.py::fused_vit_block``:
``y + fc2(gelu(fc1(LN2(y))))`` with ``y = x + proj(attn(qkv(LN1(x))))``,
y rounded to the input dtype between the halves, so the result equals the
attention half (K5, ``ops/attention.py``) followed by the MLP half (K6,
``ops/vit_mlp.py``) bit for bit. ``fused_vit_block`` runs the hand-written
Hopper kernel in ``csrc/vit_block.cu`` (one launch per block) on a CUDA
tensor and ``vit_block_reference`` on a CPU tensor; the gradient is the
plain version's VJP.
"""

from __future__ import annotations

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.attention import (
    HEAD_DIM, block_attention_reference, n_keys_checked,
    should_fuse_block_attention)
from multimodal_baby_tpu_torch.ops.vit_common import (
    PlainVJP, check_args, gelu_code)
from multimodal_baby_tpu_torch.ops.vit_mlp import (
    mlp_reference, should_fuse_mlp)

__all__ = ["fused_vit_block", "should_fuse_vit_block", "vit_block_reference"]

# K and V of one head, and one 16-row query slab per warp, in the shared
# memory of one block per SM
MAX_TOKENS = 688


def should_fuse_vit_block(n_tokens: int, num_heads: int, head_dim: int,
                          hidden: int, f_chunk: int = 512) -> bool:
    """The JAX package's gate: both halves' gates plus their co-resident
    weight sets."""
    C = num_heads * head_dim
    if not should_fuse_block_attention(n_tokens, num_heads, head_dim):
        return False
    if not should_fuse_mlp(n_tokens, C, hidden, f_chunk):
        return False
    weights = (3 * C * C + C * C + 2 * C * hidden) * 2
    return weights < 24 * 1024 * 1024


def vit_block_reference(x, g1, gb1, wq, bq, wp, bp, g2, gb2, w1, b1, w2, b2,
                        num_heads: int, scale: float,
                        kv_valid: int | None = None, eps: float = 1e-6,
                        gelu_mode: str = "erf") -> torch.Tensor:
    """The block in plain PyTorch: ``block_attention_reference`` then
    ``mlp_reference`` (the halves' own rounding points, y rounded to x's
    dtype between them, as ``_vit_block_kernel``)."""
    y = block_attention_reference(x, g1, gb1, wq, bq, wp, bp, num_heads,
                                  scale, kv_valid, eps)
    return mlp_reference(y, g2, gb2, w1, b1, w2, b2, eps, gelu_mode)


def _run(x, g1, gb1, wq, bq, wp, bp, g2, gb2, w1, b1, w2, b2, num_heads,
         scale, kv_valid, eps, gelu_mode):
    if x.device.type == "cpu":
        return vit_block_reference(x, g1, gb1, wq, bq, wp, bp, g2, gb2, w1,
                                   b1, w2, b2, num_heads, scale, kv_valid,
                                   eps, gelu_mode)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block: no kernel for device {x.device}")
    B, N, C = x.shape
    F = w1.shape[-1]
    check_args("fused_vit_block", x, {
        "g1": (g1, (C,)), "gb1": (gb1, (C,)), "wq": (wq, (C, 3 * C)),
        "bq": (bq, (3 * C,)), "wp": (wp, (C, C)), "bp": (bp, (C,)),
        "g2": (g2, (C,)), "gb2": (gb2, (C,)), "w1": (w1, (C, F)),
        "b1": (b1, (F,)), "w2": (w2, (F, C)), "b2": (b2, (C,))})
    if C % 128 or F % 128 or num_heads * HEAD_DIM != C:
        raise ValueError(
            f"fused_vit_block: needs C % 128 == 0, F % 128 == 0 and heads of "
            f"{HEAD_DIM}; got C={C}, F={F}, heads={num_heads}")
    n_keys = n_keys_checked("fused_vit_block", N, kv_valid, MAX_TOKENS)
    gelu = gelu_code(gelu_mode)
    lib = _build.library()

    def empty(width):
        return torch.empty((B, N, width), dtype=x.dtype, device=x.device)

    # intermediates in device memory: LN1/LN2 output, qkv, the attention
    # output, the half's output y and the [B, N, F] hidden
    xn, qkv, att, y, h, out = (empty(C), empty(3 * C), empty(C), empty(C),
                               empty(F), empty(C))
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.mmb_vit_block_bf16(
            *(t.data_ptr() for t in (x, g1, gb1, wq, bq, wp, bp, g2, gb2, w1,
                                     b1, w2, b2, xn, qkv, att, y, h, out,
                                     bar)),
            B, N, C, F, n_keys, gelu, scale, eps,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_vit_block")
    fused_vit_block.launches += 1
    return out


def fused_vit_block(x: torch.Tensor, g1: torch.Tensor, gb1: torch.Tensor,
                    wq: torch.Tensor, bq: torch.Tensor, wp: torch.Tensor,
                    bp: torch.Tensor, g2: torch.Tensor, gb2: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, num_heads: int, scale: float,
                    kv_valid: int | None = None, eps: float = 1e-6,
                    gelu_mode: str = "erf") -> torch.Tensor:
    """One whole pre-norm ViT block, ``x [B, N, C]`` in, the block output
    out, with the parameters (LayerNorm 1, qkv, proj, LayerNorm 2, fc1,
    fc2; matrices ``[in, out]``) cast to ``x.dtype``; key columns >=
    ``kv_valid`` masked; the GELU of ``gelu_mode``. On a CUDA tensor this
    launches the Hopper kernel once (bf16, heads of 64, C and F multiples
    of 128, N <= 688, every tensor contiguous) and raises on anything it
    cannot take; on a CPU tensor it runs ``vit_block_reference``. The
    gradient is the VJP of ``vit_block_reference``.
    ``fused_vit_block.launches`` counts kernel launches."""
    dt = x.dtype
    params = [t.to(dt) for t in (g1, gb1, wq, bq, wp, bp, g2, gb2, w1, b1,
                                 w2, b2)]
    return PlainVJP.apply(_run, vit_block_reference,
                          (num_heads, scale, kv_valid, eps, gelu_mode), x,
                          *params)


fused_vit_block.launches = 0
