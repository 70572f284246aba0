"""What the two ViT block kernels (K5 ``ops/attention.py``, K6
``ops/vit_mlp.py``) share: the LayerNorm at their rounding points, the
argument checks, and the autograd Function whose backward is the VJP of the
plain version (the JAX package's custom VJPs take the XLA oracle's, since
the ViT trunk is frozen in the CVCL recipes and only the forward is hot).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis as the Pallas kernels compute it:
    statistics in f32 with var = E[x^2] - mean^2 (not two-pass), the affine
    in f32, the result rounded to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


def check_args(what: str, x: torch.Tensor,
               shapes: Dict[str, Tuple[torch.Tensor, tuple]]) -> None:
    """Raise ValueError unless ``x`` is bf16 ``[B, N, C]`` and every named
    tensor has its shape, and all are bf16, on x's device, contiguous and
    16-byte aligned (what the CUDA entry points assume)."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{what}: {msg}")

    need(x.dim() == 3, f"x must be [B, N, C], got {tuple(x.shape)}")
    need(x.numel() < 2**31, "x is too large for 32-bit indexing")
    for name, (t, shape) in {"x": (x, tuple(x.shape)), **shapes}.items():
        need(tuple(t.shape) == shape,
             f"{name} must be {shape}, got {tuple(t.shape)}")
        need(t.dtype == torch.bfloat16, f"{name} must be bfloat16, got "
             f"{t.dtype}")
        need(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        need(t.is_contiguous(), f"{name} must be contiguous")
        need(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


class PlainVJP(torch.autograd.Function):
    """``apply(run, reference, statics, *tensors)``: the forward is
    ``run(*tensors, *statics)`` (the kernel's wrapper), the backward the VJP
    of ``reference(*tensors, *statics)``, recomputed from the saved
    inputs."""

    @staticmethod
    def forward(ctx, run: Callable, reference: Callable, statics: tuple,
                *tensors: torch.Tensor) -> torch.Tensor:
        ctx.reference, ctx.statics = reference, statics
        ctx.save_for_backward(*tensors)
        return run(*tensors, *statics)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ctx.reference(*inputs, *ctx.statics)
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, None,
                *(next(grads) if n else None for n in needs))
