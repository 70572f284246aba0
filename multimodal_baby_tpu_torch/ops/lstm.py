"""The masked LSTM recurrence (K9) for the PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/lstm.py``: the sequential part of
an LSTM over precomputed input projections, time-major. ``lstm_fused`` runs
the hand-written Hopper kernel in ``csrc/lstm.cu`` (one cooperative launch
per sequence, its products as three TF32 tensor-core products) on a CUDA
tensor and ``scan_reference`` on a CPU tensor; its backward replays
``scan_reference`` under autograd, as the JAX VJP replays the XLA scan.
Everything is f32 at the interface.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodal_baby_tpu_torch.ops import _build

__all__ = ["MAX_HIDDEN", "kernel_takes", "lstm_fused", "scan_reference"]

# W_hh's 16 gate columns x H and a 32-row h tile in one SM's shared memory
MAX_HIDDEN = 576
UNITS = 16
ROWS = 32        # batch rows per tile: a flag per (row tile, unit tile)
FLAGS0 = 32      # the sync words before the flags


def kernel_takes(batch: int, hidden: int) -> bool:
    """The kernel's shape limits: H a multiple of 16 up to MAX_HIDDEN."""
    return batch >= 1 and hidden % UNITS == 0 and UNITS <= hidden <= MAX_HIDDEN


def scan_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                   w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked scan (``_scan_reference``). x_proj [L, B, 4H] (input
    projection plus both biases), mask [L, B] (1 at valid steps), w_hh
    [H, 4H], h0 and c0 [B, H]. Returns (out [L, B, H], zero at padding;
    h_last, c_last [B, H]), the carries at each row's last valid step."""
    H = h0.shape[-1]
    h, c = h0, c0
    outs = []
    for t in range(x_proj.shape[0]):
        pre = x_proj[t] + h @ w_hh
        i, f, g, o = pre.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outs.append(m * h_new)
    return torch.stack(outs), h, c


def _run(x_proj, mask, w_hh, h0, c0):
    if x_proj.device.type == "cpu":
        return scan_reference(x_proj, mask, w_hh, h0, c0)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_fused: no kernel for device {x_proj.device}")
    L, B, H4 = x_proj.shape
    H = H4 // 4
    shapes = {"x_proj": (x_proj, (L, B, 4 * H)), "mask": (mask, (L, B)),
              "w_hh": (w_hh, (H, 4 * H)), "h0": (h0, (B, H)),
              "c0": (c0, (B, H))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"lstm_fused: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x_proj.device or not t.is_contiguous():
            raise ValueError(f"lstm_fused: {name} must be contiguous on "
                             f"{x_proj.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"lstm_fused: {name} must be 16-byte aligned")
    if L < 1 or H4 % 4 or not kernel_takes(B, H):
        raise ValueError(f"lstm_fused: needs L >= 1 and H a multiple of "
                         f"{UNITS} up to {MAX_HIDDEN}; got L={L}, 4H={H4}")
    if x_proj.numel() >= 2**31:
        raise ValueError("lstm_fused: x_proj is too large for 32-bit indexing")
    lib = _build.library()
    # out, h_last, c_last and the two h buffers in one allocation
    buf = torch.empty((L + 4, B, H), dtype=torch.float32,
                      device=x_proj.device)
    out, h_last, c_last, hbuf = buf[:L], buf[L], buf[L + 1], buf[L + 2:]
    with _build.on_device(x_proj.get_device()):
        stream, sync = _build.sync_words(
            "lstm", FLAGS0 + -(-B // ROWS) * (H // UNITS))
        code = lib.mmb_lstm_f32(
            *(t.data_ptr() for t in (x_proj, mask, w_hh, h0, c0, out, h_last,
                                     c_last, hbuf, sync)),
            L, B, H, stream)
    _build.check(lib, code, "lstm_fused")
    lstm_fused.launches += 1
    return out, h_last, c_last


class _LSTMFused(torch.autograd.Function):
    """Forward: the kernel (the plain scan on a CPU tensor). Backward: the
    VJP of ``scan_reference`` recomputed from the saved inputs; the mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, x_proj, mask, w_hh, h0, c0):
        ctx.save_for_backward(x_proj, mask, w_hh, h0, c0)
        return _run(x_proj, mask, w_hh, h0, c0)

    @staticmethod
    def backward(ctx, d_out, d_h, d_c):
        x_proj, mask, w_hh, h0, c0 = ctx.saved_tensors
        needs = [ctx.needs_input_grad[i] for i in (0, 2, 3, 4)]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip((x_proj, w_hh, h0, c0), needs)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            outs = scan_reference(inputs[0], mask, *inputs[1:])
        grads = iter(torch.autograd.grad(outs, wanted, (d_out, d_h, d_c),
                                         allow_unused=True))
        dxp, dw, dh0, dc0 = (next(grads) if n else None for n in needs)
        return dxp, None, dw, dh0, dc0


def lstm_fused(x_proj: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked LSTM recurrence over ``x_proj`` [L, B, 4H] (time-major,
    biases included), ``mask`` [L, B] (float 0/1), ``w_hh`` [H, 4H], ``h0``
    and ``c0`` [B, H], all f32. Returns (out [L, B, H], h_last, c_last). On
    a CUDA tensor this launches the Hopper kernel once (every tensor
    contiguous, H a multiple of 16 up to MAX_HIDDEN) and raises on anything
    it cannot take; it never falls back. On a CPU tensor it runs
    ``scan_reference``. ``lstm_fused.launches`` counts kernel launches."""
    return _LSTMFused.apply(x_proj, mask, w_hh, h0, c0)


lstm_fused.launches = 0
