"""The fused symmetric InfoNCE (K4) for the PyTorch port.

Counterpart of ``multimodal_baby_tpu/ops/infonce.py``: the similarity
product times exp(-log T) and both cross-entropies of the B x B logits,
with the metrics, as one forward kernel and one backward kernel
(``csrc/infonce.cu``, one cooperative launch each) on a CUDA tensor, and
their plain versions (``infonce_reference``,
``infonce_backward_reference``) on a CPU tensor. The metrics are the
kernel's: an accuracy counts the diagonal where it is >= its row's (or
column's) max, so ties count; an entropy is ``sum p (lse - logit)``.
``infonce_loss`` is the entry point with the JAX package's shape rule. No
train step calls it: the JAX package's step uses the XLA loss too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from multimodal_baby_tpu_torch.models.losses import (
    contrastive_loss_from_logits)
from multimodal_baby_tpu_torch.ops import _build

__all__ = ["MAX_FUSED_BATCH", "fused_infonce", "fused_infonce_backward",
           "fused_infonce_forward", "fused_infonce_with_metrics",
           "infonce_backward_reference", "infonce_loss", "infonce_reference"]

MAX_FUSED_BATCH = 1024
METRICS = ("image_accuracy", "text_accuracy", "image_entropy", "text_entropy")
TILE = 64


def infonce_reference(img: torch.Tensor, txt: torch.Tensor,
                      neg_log_temp: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The forward in plain PyTorch (f32): (loss, lse_i [B], lse_t [B],
    metrics [4] in METRICS order). Differentiable in the loss; the
    metrics carry no gradient."""
    logits = neg_log_temp.exp() * (img @ txt.T)
    B = logits.shape[0]
    lse_i = torch.logsumexp(logits, dim=1)
    lse_t = torch.logsumexp(logits, dim=0)
    diag = logits.diagonal()
    loss = ((lse_i - diag).sum() + (lse_t - diag).sum()) / (2 * B)
    with torch.no_grad():
        lg, d = logits.detach(), diag.detach()
        li, lt = lse_i.detach(), lse_t.detach()
        metrics = torch.stack([
            (d >= lg.max(dim=1).values).float().mean(),
            (d >= lg.max(dim=0).values).float().mean(),
            ((lg - li[:, None]).exp() * (li[:, None] - lg)).sum() / B,
            ((lg - lt[None, :]).exp() * (lt[None, :] - lg)).sum() / B])
    return loss, lse_i, lse_t, metrics


def infonce_backward_reference(img, txt, neg_log_temp, lse_i, lse_t, g
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The backward in plain PyTorch (``_bwd_kernel``): D = g ((P_row - I)
    + (P_col - I)) / 2B from the saved LSEs; returns (s D txt, s D^T img,
    sum D * logits) with s = exp(neg_log_temp)."""
    scale = neg_log_temp.exp()
    logits = scale * (img @ txt.T)
    B = logits.shape[0]
    eye = torch.eye(B, dtype=logits.dtype, device=logits.device)
    d = g * (((logits - lse_i[:, None]).exp() - eye)
             + ((logits - lse_t[None, :]).exp() - eye)) / (2 * B)
    return scale * (d @ txt), scale * (d.T @ img), (d * logits).sum()


def _check(what: str, tensors: Dict[str, Tuple[torch.Tensor, tuple]]
           ) -> None:
    device = next(iter(tensors.values()))[0].device
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte "
                             f"aligned and on {device}")


def _shape(what: str, img: torch.Tensor) -> Tuple[int, int]:
    B, E = img.shape
    if B % 4 or E % 4 or not 1 <= B <= MAX_FUSED_BATCH:
        raise ValueError(f"{what}: needs B % 4 == 0, E % 4 == 0 and B <= "
                         f"{MAX_FUSED_BATCH}; got B={B}, E={E}")
    return B, E


def fused_infonce_forward(img: torch.Tensor, txt: torch.Tensor,
                          nlt: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K4's forward kernel on f32 CUDA tensors (``infonce_reference`` on CPU
    tensors): (loss, lse_i, lse_t, metrics), no autograd."""
    if img.device.type == "cpu":
        with torch.no_grad():
            return infonce_reference(img, txt, nlt)
    if img.device.type != "cuda":
        raise ValueError(f"fused_infonce: no kernel for device {img.device}")
    B, E = _shape("fused_infonce", img)
    _check("fused_infonce", {"img": (img, (B, E)), "txt": (txt, (B, E)),
                             "neg_log_temp": (nlt, ())})
    lib = _build.library()
    tiles = (B + TILE - 1) // TILE

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=img.device)

    part, loss, lse_i, lse_t, metrics = (new(6 * tiles * B + B), new(),
                                         new(B), new(B), new(4))
    bar = torch.zeros(2, dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        code = lib.mmb_infonce_fwd_f32(
            *(t.data_ptr() for t in (img, txt, nlt, part, loss, lse_i, lse_t,
                                     metrics, bar)),
            B, E, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_infonce")
    fused_infonce_with_metrics.launches += 1
    return loss, lse_i, lse_t, metrics


def fused_infonce_backward(img: torch.Tensor, txt: torch.Tensor,
                           nlt: torch.Tensor, lse_i: torch.Tensor,
                           lse_t: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K4's backward kernel on f32 CUDA tensors
    (``infonce_backward_reference`` on CPU tensors): (d_img, d_txt,
    d_neg_log_temp) for the loss's cotangent ``g``."""
    if img.device.type == "cpu":
        return infonce_backward_reference(img, txt, nlt, lse_i, lse_t, g)
    if img.device.type != "cuda":
        raise ValueError(f"fused_infonce backward: no kernel for device "
                         f"{img.device}")
    B, E = _shape("fused_infonce backward", img)
    g = g.to(torch.float32).contiguous()
    _check("fused_infonce backward", {
        "img": (img, (B, E)), "txt": (txt, (B, E)),
        "neg_log_temp": (nlt, ()), "lse_i": (lse_i, (B,)),
        "lse_t": (lse_t, (B,)), "g": (g, ())})
    lib = _build.library()
    tiles = (B + TILE - 1) // TILE
    D = torch.empty((B, B), dtype=torch.float32, device=img.device)
    part = torch.empty(tiles * tiles, dtype=torch.float32, device=img.device)
    dimg, dtxt = torch.empty_like(img), torch.empty_like(txt)
    dnlt = torch.empty((), dtype=torch.float32, device=img.device)
    bar = torch.zeros(2, dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        code = lib.mmb_infonce_bwd_f32(
            *(t.data_ptr() for t in (img, txt, nlt, lse_i, lse_t, g, D, part,
                                     dimg, dtxt, dnlt, bar)),
            B, E, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_infonce backward")
    fused_infonce_with_metrics.launches_bwd += 1
    return dimg, dtxt, dnlt


class _FusedInfoNCE(torch.autograd.Function):
    """Forward and backward through K4's two kernels on f32 copies of the
    inputs; the gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, img, txt, nlt):
        img32, txt32, nlt32 = (t.detach().float().contiguous()
                               for t in (img, txt, nlt))
        loss, lse_i, lse_t, metrics = fused_infonce_forward(img32, txt32,
                                                           nlt32)
        ctx.save_for_backward(img32, txt32, nlt32, lse_i, lse_t)
        ctx.dtypes = (img.dtype, txt.dtype, nlt.dtype)
        ctx.mark_non_differentiable(metrics)
        return loss, metrics

    @staticmethod
    def backward(ctx, g, _):
        dimg, dtxt, dnlt = fused_infonce_backward(*ctx.saved_tensors, g)
        return tuple(d.to(dt) for d, dt in zip((dimg, dtxt, dnlt),
                                               ctx.dtypes))


def fused_infonce_with_metrics(img: torch.Tensor, txt: torch.Tensor,
                               neg_log_temp: torch.Tensor
                               ) -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over exp(neg_log_temp) img . txt^T (img, txt
    [B, E]; neg_log_temp a scalar), with the kernel's accuracy and entropy
    metrics. Returns (loss, metrics dict). On CUDA tensors this launches
    K4's forward kernel (B % 4 == 0, E % 4 == 0, B <= MAX_FUSED_BATCH) and
    its backward kernel when a gradient is asked for, and raises on what
    they cannot take; on CPU tensors it runs the plain versions.
    ``fused_infonce_with_metrics.launches`` and ``.launches_bwd`` count
    launches."""
    nlt = torch.as_tensor(neg_log_temp, dtype=torch.float32,
                          device=img.device)
    loss, metrics = _FusedInfoNCE.apply(img, txt, nlt)
    return loss, dict(zip(METRICS, metrics.unbind()))


fused_infonce_with_metrics.launches = 0
fused_infonce_with_metrics.launches_bwd = 0


def fused_infonce(img: torch.Tensor, txt: torch.Tensor,
                  neg_log_temp: torch.Tensor) -> torch.Tensor:
    """The loss of ``fused_infonce_with_metrics``."""
    return fused_infonce_with_metrics(img, txt, neg_log_temp)[0]


def infonce_loss(img: torch.Tensor, txt: torch.Tensor,
                 neg_log_temp: torch.Tensor) -> torch.Tensor:
    """The JAX package's dispatch: K4 when B <= MAX_FUSED_BATCH and
    B % 8 == 0, else the plain formula (``contrastive_loss_from_logits`` on
    exp(neg_log_temp) img . txt^T), the reference's own semantics."""
    B = img.shape[0]
    if B <= MAX_FUSED_BATCH and B % 8 == 0:
        return fused_infonce(img, txt, neg_log_temp)
    logits = torch.as_tensor(neg_log_temp).exp() * (img @ txt.T)
    loss, _ = contrastive_loss_from_logits(logits, logits.T)
    return loss
