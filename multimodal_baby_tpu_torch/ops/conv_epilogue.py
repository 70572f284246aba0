"""The fused 1x1 convolution + BatchNorm + residual + ReLU (K11) for the
PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/conv_epilogue.py``: a bottleneck
block's closing sequence (conv3, bn3 on running statistics, the residual
add, ReLU) over NHWC pixels flattened to rows, as one GEMM whose epilogue
applies the rest before the single write:

    out = relu((x @ w) * mul + add + residual)

``conv1x1_bn_residual_relu`` runs the hand-written Hopper kernel
(``csrc/conv_epilogue.cu``) on CUDA tensors and ``epilogue_reference`` on
CPU tensors. Its gradient is the autograd of the plain version, as the JAX
package's custom VJP recomputes with XLA ops. The JAX package tiles M by its
largest power-of-two divisor and leaves M below 8 to XLA, a TPU layout
rule; the kernel takes any M, so on CUDA every call launches it.
"""

from __future__ import annotations

import torch

from multimodal_baby_tpu_torch.ops import _build

__all__ = ["epilogue_reference", "conv1x1_bn_residual_relu"]


def epilogue_reference(x: torch.Tensor, w: torch.Tensor, mul: torch.Tensor,
                       add: torch.Tensor, residual: torch.Tensor
                       ) -> torch.Tensor:
    """K11's plain version (the JAX package's ``_xla_epilogue``): x [M,
    Cin], w [Cin, Cout], mul and add [Cout] f32, residual [M, Cout]; the
    product and the epilogue in f32, the output in the residual's dtype."""
    f32 = torch.float32
    y = (x.to(f32) @ w.to(f32)) * mul + add + residual.to(f32)
    return torch.relu(y).to(residual.dtype)


def _check(x, w, mul, add, residual) -> None:
    def need(cond, msg):
        if not cond:
            raise ValueError(f"conv1x1_bn_residual_relu: {msg}")

    need(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
         f"x [M, Cin] and w [Cin, Cout], got {tuple(x.shape)} and "
         f"{tuple(w.shape)}")
    M, cin = x.shape
    cout = w.shape[1]
    need(tuple(residual.shape) == (M, cout),
         f"residual must be {(M, cout)}, got {tuple(residual.shape)}")
    need(tuple(mul.shape) == (cout,) and tuple(add.shape) == (cout,),
         f"mul and add must be ({cout},)")
    for name, t, dtype in (("x", x, torch.bfloat16), ("w", w, torch.bfloat16),
                           ("mul", mul, torch.float32),
                           ("add", add, torch.float32),
                           ("residual", residual, torch.bfloat16)):
        need(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        need(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        need(t.is_contiguous(), f"{name} must be contiguous")
        need(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    need(M >= 1 and cin % 32 == 0 and cout % 128 == 0,
         f"needs M >= 1, Cin % 32 == 0, Cout % 128 == 0; got M={M}, "
         f"Cin={cin}, Cout={cout}")
    need(M * max(cin, cout) < 2**31, "x is too large for 32-bit indexing")


def _launch(x, w, mul, add, residual) -> torch.Tensor:
    _check(x, w, mul, add, residual)
    lib = _build.library()
    M, cin = x.shape
    cout = w.shape[1]
    out = torch.empty((M, cout), dtype=residual.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.mmb_conv1x1_bn_residual_relu_bf16(
            x.data_ptr(), w.data_ptr(), mul.data_ptr(), add.data_ptr(),
            residual.data_ptr(), out.data_ptr(), M, cin, cout,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "conv1x1_bn_residual_relu")
    conv1x1_bn_residual_relu.launches += 1
    return out


class _Epilogue(torch.autograd.Function):
    """The kernel forward; the backward is the plain version's autograd."""

    @staticmethod
    def forward(ctx, x, w, mul, add, residual):
        ctx.save_for_backward(x, w, mul, add, residual)
        return _launch(x, w, mul, add, residual)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * len(inputs)
        with torch.enable_grad():
            out = epilogue_reference(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def conv1x1_bn_residual_relu(x: torch.Tensor, w: torch.Tensor,
                             mul: torch.Tensor, add: torch.Tensor,
                             residual: torch.Tensor) -> torch.Tensor:
    """relu((x @ w) * mul + add + residual) in the residual's dtype.

    On CUDA tensors (bf16 x, w and residual, f32 mul and add; Cin % 32 ==
    0, Cout % 128 == 0) this launches the kernel and raises on anything it
    cannot take; on CPU tensors it runs ``epilogue_reference``. Differentiable
    in every input. ``conv1x1_bn_residual_relu.launches`` counts launches."""
    if x.device.type == "cpu":
        return epilogue_reference(x, w, mul, add, residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1_bn_residual_relu: no kernel for device "
                         f"{x.device}")
    return _Epilogue.apply(x, w, mul, add, residual)


conv1x1_bn_residual_relu.launches = 0
