"""Train and eval steps (counterpart of ``multimodal_baby_tpu/train/step.py``)
on one device: the joint loss lambda_mm InfoNCE + lambda_lm LM
cross-entropy + lambda_ar attention regulariser."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.config import ExperimentConfig
from multimodal_baby_tpu_torch.core.constants import PAD_TOKEN_ID
from multimodal_baby_tpu_torch.data.augment import augment_batch
from multimodal_baby_tpu_torch.models import losses as L
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.models.quant_calib import calibrate_cvcl
from multimodal_baby_tpu_torch.train.optimizer import build_optimizer

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    model: CVCL
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # augment and dropout draws, model's device
    step: int = 0  # train steps taken


def init_train_state(model: CVCL, cfg: ExperimentConfig) -> TrainState:
    """Optimizer over the model's trainable parameters and a generator for
    the augment and the dropout, on the model's device, seeded with
    ``cfg.train.seed``."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.train.seed)
    return TrainState(model, build_optimizer(cfg, model), generator)


class HostStaging:
    """A ring of ``depth`` pinned host slots for ``device_batch``'s copies
    to a CUDA device, sized from the first batch (a larger batch, or a key
    of another shape or dtype, re-allocates that slot).

    A batch is copied into the next slot, then from the slot to the device
    with ``non_blocking=True``, and a CUDA event is recorded after the
    slot's copies. Before a slot is written again, the host waits on that
    event: a slot refilled while its earlier copy is still queued would
    hand the device a later batch's data. With ``depth`` slots the host
    may run ``depth - 1`` batches ahead of the copies."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._slots = [dict() for _ in range(depth)]
        self._events = [None] * depth
        self._next = 0

    def to_device(self, arrays: Mapping[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
        """The arrays on the CUDA ``device``, through the next slot: the
        host waits for the slot's previous copies, fills it, queues its
        copies and records their event."""
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()
        slot, out = self._slots[i], {}
        for k, v in arrays.items():
            src = torch.from_numpy(v)
            buf = slot.get(k)
            if (buf is None or buf.shape[1:] != src.shape[1:]
                    or buf.shape[0] < src.shape[0]
                    or buf.dtype != src.dtype):
                buf = slot[k] = torch.empty(src.shape, dtype=src.dtype,
                                            pin_memory=True)
            staged = buf[:src.shape[0]]
            # one memcpy on this thread: torch's threaded copy_ slows
            # several-fold beside the loader's decoding threads
            np.copyto(staged.numpy(), v)
            out[k] = staged.to(device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record()
        return out


def device_batch(batch: Mapping[str, np.ndarray], device,
                 staging: HostStaging | None = None) -> Batch:
    """A host batch (the loader's numpy arrays) on ``device``, token ids
    and lengths as int64; the raw utterances stay behind. On one device
    the JAX package pads no tail batch (``parallel/mesh.py:80``), so a tail
    batch keeps its true size.

    On a CUDA device every array goes through a pinned slot of ``staging``
    (a ring the caller keeps across batches; without one, a ring of one
    slot for this call) and is copied without blocking the host; int32
    arrays are copied as int32 and widened on the device. On the CPU each
    array is converted and copied as it is."""
    device = torch.device(device)
    arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()
              if k != "raw"}
    if device.type != "cuda":
        return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                    else v).to(device)
                for k, v in arrays.items()}
    out = (staging or HostStaging(1)).to_device(arrays, device)
    return {k: v.long() if v.dtype == torch.int32 else v
            for k, v in out.items()}


def calibrate_trunk(model: CVCL, batch: Batch, n: int = 32):
    """Measure the int8 trunk's activation ranges once, before the first
    step, as the published recipe does (``bench.py:146-151``): on the
    first ``n`` frames of ``batch`` with the augment off, written into the
    trunk's amax buffers. Returns the scales, or None for a trunk without
    an int8 stage."""
    trunk = model.vision_encoder.model
    if not any(getattr(trunk, "int8_plan", ())):
        return None
    images = (batch["image"] if "image" in batch
              else augment_batch(batch["image_u8"][:n], augment=False))
    return calibrate_cvcl(model, images[:n])


def make_loss_fn(model: CVCL, cfg: ExperimentConfig) -> Callable:
    """loss_fn(batch, train, generator) -> (loss, metrics). In training,
    ``generator`` draws the augment and the text encoder's dropout.

    ``batch`` holds ``text`` [B, L], ``text_len`` [B], optional ``valid``
    [B], and either ``image`` (normalized [B, H, W, 3]) or ``image_u8``
    (raw frames, augmented and normalized here on the device). The
    contrastive half runs when ``lambda_mm`` is nonzero or unused terms are
    not skipped (``optimize_unused`` False), the LM half likewise with
    ``lambda_lm``; the frames are read only when a half needs them."""
    t = cfg.train
    use_mm = bool(t.lambda_mm) or not t.optimize_unused
    use_lm = bool(t.lambda_lm) or not t.optimize_unused
    text_cfg = cfg.model.text
    needs_image = use_mm or (use_lm and (text_cfg.captioning
                                         or text_cfg.attention))
    compute_dtype = (torch.bfloat16
                     if cfg.parallel.compute_dtype == "bfloat16"
                     else torch.float32)

    def loss_fn(batch: Batch, train: bool,
                generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, Metrics]:
        image = None
        if needs_image and "image" in batch:
            image = batch["image"]
        elif needs_image:
            image = augment_batch(
                batch["image_u8"], augment=cfg.data.augment_frames and train,
                dtype=compute_dtype, generator=generator)
        out = model.joint_forward(image, batch["text"], batch["text_len"],
                                  train=train, generator=generator,
                                  use_mm=use_mm, use_lm=use_lm)
        # a padded tail batch marks its real rows: they alone count
        valid = batch.get("valid")
        metrics: Metrics = {
            "batch_size": (valid.sum().float() if valid is not None
                           else torch.tensor(float(batch["text"].shape[0]))),
            "temperature": torch.exp(-out["logit_neg_log_temperature"]),
        }
        infonce = lm_ce = attn_reg = 0.0
        if use_mm:
            infonce, m = L.contrastive_loss_from_logits(
                out["logits_per_image"], out["logits_per_text"], valid=valid)
            metrics.update(m)
            metrics["infonce_loss"] = infonce
        if use_lm:
            labels = out["lm_labels"]
            if valid is not None:  # padded rows add no tokens
                labels = torch.where(valid[:, None], labels, PAD_TOKEN_ID)
            ce, _ = L.lm_cross_entropy(out["lm_logits"], labels)
            breakdown = L.lm_loss_breakdown(ce, labels)
            metrics.update(breakdown)
            lm_ce = breakdown["ce_loss"]
            if text_cfg.attention and out.get("attns") is not None:
                attn_reg = L.attn_reg_loss(out["attns"])
                metrics["attn_reg_loss"] = attn_reg
        loss = torch.as_tensor(t.lambda_mm * infonce + t.lambda_lm * lm_ce
                               + t.lambda_ar * attn_reg)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(model: CVCL, cfg: ExperimentConfig
                    ) -> Callable[[TrainState, Batch], Metrics]:
    """Returns train_step(state, batch) -> metrics; updates the model's
    trainable parameters in place and counts the step."""
    loss_fn = make_loss_fn(model, cfg)

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        state.step += 1
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, True, state.generator)
        loss.backward()
        # optax's masked AdamW updates every trainable leaf, a zero gradient
        # included (its weight decay still applies); torch's AdamW skips a
        # parameter whose .grad is None. Zero-filling keeps the two equal.
        # It matters for parameters outside the graph of the terms in use:
        # e.g. the vision head in the LM-only recipe, or the LM bias, which
        # decay shrinks when a checkpoint made it nonzero.
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: CVCL, cfg: ExperimentConfig
                   ) -> Callable[[Batch], Metrics]:
    """Validation step: loss and metrics, no gradients, no augment."""
    loss_fn = make_loss_fn(model, cfg)

    def eval_step(batch: Batch) -> Metrics:
        with torch.no_grad():
            _, metrics = loss_fn(batch, False)
        return metrics

    return eval_step
