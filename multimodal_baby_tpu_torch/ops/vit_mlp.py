"""The fused ViT MLP half (K6) for the PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/vit_mlp.py``:
``x + fc2(gelu(fc1(LayerNorm(x))))`` on ``x [B, N, C]`` with ``w1 [C, F]``
and ``w2 [F, C]`` (the JAX package's ``[in, out]`` layout). ``fused_mlp``
runs the hand-written Hopper kernel in ``csrc/vit.cu`` on a CUDA tensor
and ``mlp_reference`` on a CPU tensor. ``gelu_mode`` is the JAX package's
``MMB_VIT_GELU`` form: ``erf`` (CUDA ``erff``; the TPU kernel's rational
erfc only worked around Mosaic's missing erf), ``tanh`` or ``sigmoid``.
"""

from __future__ import annotations

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.vit_common import (
    PlainVJP, check_args, gelu, gelu_code, layer_norm)

__all__ = ["mlp_reference", "fused_mlp", "should_fuse_mlp"]


def should_fuse_mlp(n_tokens: int, dim: int, hidden: int,
                    f_chunk: int = 512) -> bool:
    """The JAX package's shape gate (``vit_mlp.should_fuse_mlp``): the
    hidden width a multiple of the chunk, and the TPU kernel's VMEM
    budget."""
    if hidden % f_chunk:
        return False
    weights = 2 * dim * hidden * 2
    cell = (4 * n_tokens * dim * 4 + 2 * n_tokens * f_chunk * 4)
    return weights + 2 * cell < 96 * 1024 * 1024


def mlp_reference(x: torch.Tensor, ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  eps: float = 1e-6, gelu_mode: str = "erf") -> torch.Tensor:
    """The MLP half in plain PyTorch with the kernel's rounding points
    (``_mlp_half_f32``): LayerNorm rounded to ``x.dtype``; h = xn . w1 + b1
    kept in f32 into the GELU of ``gelu_mode``, whose output is rounded;
    the residual sum ``x + g . w2 + b2`` in f32, rounded once. The
    parameters are used in ``x.dtype``, as the JAX wrapper casts them."""
    dt = x.dtype
    f32 = torch.float32
    xn = layer_norm(x, ln_scale.to(dt), ln_bias.to(dt), eps)
    h = xn.to(f32) @ w1.to(dt).to(f32) + b1.to(dt).to(f32)
    g = gelu(h, gelu_mode).to(dt)
    y = g.to(f32) @ w2.to(dt).to(f32)
    return (x.to(f32) + y + b2.to(dt).to(f32)).to(dt)


def _run(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_mode):
    if x.device.type == "cpu":
        return mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                             gelu_mode)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    B, N, C = x.shape
    hidden = w1.shape[-1]
    check_args("fused_mlp", x, {
        "ln_scale": (ln_scale, (C,)), "ln_bias": (ln_bias, (C,)),
        "w1": (w1, (C, hidden)), "b1": (b1, (hidden,)),
        "w2": (w2, (hidden, C)), "b2": (b2, (C,))})
    if C % 128 or hidden % 128:
        raise ValueError(f"fused_mlp: needs C % 128 == 0 and F % 128 == 0; "
                         f"got C={C}, F={hidden}")
    lib = _build.library()
    xn = torch.empty_like(x)
    h = torch.empty((B, N, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.mmb_vit_mlp_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            xn.data_ptr(), h.data_ptr(), out.data_ptr(), B * N, C, hidden,
            gelu_code(gelu_mode), eps,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_mlp")
    fused_mlp.launches += 1
    return out


def fused_mlp(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, eps: float = 1e-6,
              gelu_mode: str = "erf") -> torch.Tensor:
    """``x + fc2(gelu(fc1(LayerNorm(x))))`` with the parameters cast to
    ``x.dtype`` and the GELU of ``gelu_mode``. On a CUDA tensor this launches the Hopper kernel (bf16,
    C and F multiples of 128, every tensor contiguous) and raises on
    anything it cannot take; it never falls back. On a CPU tensor it runs
    ``mlp_reference``. The gradient is the VJP of ``mlp_reference``.
    ``fused_mlp.launches`` counts kernel launches."""
    dt = x.dtype
    params = [t.to(dt) for t in (ln_scale, ln_bias, w1, b1, w2, b2)]
    return PlainVJP.apply(_run, mlp_reference, (eps, gelu_mode), x, *params)


fused_mlp.launches = 0
