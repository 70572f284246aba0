"""What the ViT kernels (K5 and K8a-c ``ops/attention.py``, K6
``ops/vit_mlp.py``, K7 ``ops/vit_block.py``) share: the LayerNorm at their
rounding points, the GELU forms, the argument checks, and the autograd
Function whose backward is the VJP of the plain version (the JAX package's
custom VJPs take the XLA oracle's, since the ViT trunk is frozen in the
CVCL recipes and only the forward is hot). A trained trunk takes its
whole gradient through it: CLIP ViT-L/14 (``models/clip.py``) recomputes
each block's plain version, in its f32 products, in the backward.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.train.profiler import span

# the MLP activation's forms (the JAX package's MMB_VIT_GELU), in the order
# of the kernels' `gelu` argument
GELU_MODES = ("erf", "tanh", "sigmoid")


def gelu(h: torch.Tensor, mode: str = "erf") -> torch.Tensor:
    """The MLP activation (``vit_mlp._gelu_f32`` of the JAX package): the
    exact erf form; the tanh approximation 0.5 h (1 + tanh(0.7978845608
    (h + 0.044715 h^3))); or h sigmoid(1.702 h). erf runs in h's dtype as
    ``F.gelu`` does; the other two are computed in f32 and rounded to h's
    dtype."""
    if mode == "erf":
        return F.gelu(h)
    h32 = h.float()
    if mode == "tanh":
        c = 0.7978845608028654  # sqrt(2 / pi)
        out = 0.5 * h32 * (1.0 + torch.tanh(c * (h32 + 0.044715 * h32 * h32
                                                   * h32)))
    elif mode == "sigmoid":
        out = h32 * torch.sigmoid(1.702 * h32)
    else:
        raise ValueError(f"gelu mode must be one of {GELU_MODES}, got "
                         f"{mode!r}")
    return out.to(h.dtype)


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
               shapes: Dict[str, Tuple[torch.Tensor, tuple]],
               strided: bool = False) -> None:
    """Raise ValueError unless ``x`` is bf16 ``[B, N, C]`` and every named
    tensor has its shape, and all are bf16, on x's device, contiguous and
    16-byte aligned (what the CUDA entry points assume). ``strided``: x and
    the named tensors may instead be views whose last axis is contiguous
    and whose other strides are multiples of 8 elements (16 bytes)."""
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
        if strided:
            need(t.stride(-1) == 1
                 and all(s % 8 == 0 for s in t.stride()[:-1]),
                 f"{name} needs a contiguous last axis and 16-byte strides, "
                 f"got strides {t.stride()}")
        else:
            need(t.is_contiguous(), f"{name} must be contiguous")
        need(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def gelu_code(mode: str) -> int:
    """The kernels' `gelu` argument for a GELU form."""
    if mode not in GELU_MODES:
        raise ValueError(f"gelu mode must be one of {GELU_MODES}, got "
                         f"{mode!r}")
    return GELU_MODES.index(mode)


class PlainVJP(torch.autograd.Function):
    """``apply(run, reference, statics, *tensors)``: the forward is
    ``run(*tensors, *statics)`` (the kernel's wrapper), the backward the VJP
    of ``reference(*tensors, *statics)``, recomputed from the saved
    inputs.

    Each backward runs inside the program span ``mmb/vjp/<kernel>``, the
    reference's name less ``_reference`` (``block_attention`` for K5,
    ``mlp`` for K6), and adds one to ``PlainVJP.backward_calls``. On the
    card autograd runs it on its device thread; ``train/profiler.py``
    nests the span under the calling thread's ``mmb/backward``."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, run: Callable, reference: Callable, statics: tuple,
                *tensors: torch.Tensor) -> torch.Tensor:
        ctx.reference, ctx.statics = reference, statics
        ctx.save_for_backward(*tensors)
        return run(*tensors, *statics)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        PlainVJP.backward_calls += 1
        name = ctx.reference.__name__.removesuffix("_reference")
        with span("vjp/" + name):
            needs = ctx.needs_input_grad[3:]
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            wanted = [t for t in inputs if t.requires_grad]
            with torch.enable_grad():
                out = ctx.reference(*inputs, *ctx.statics)
            grads = iter(torch.autograd.grad(out, wanted, grad))
            return (None, None, None,
                    *(next(grads) if n else None for n in needs))
