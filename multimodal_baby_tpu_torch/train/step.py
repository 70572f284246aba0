"""Train and eval steps (counterpart of ``multimodal_baby_tpu/train/step.py``):
the joint loss lambda_mm InfoNCE + lambda_lm LM cross-entropy + lambda_ar
attention regulariser, on one device or over a (data, model) mesh
(``parallel/``).

On a mesh each rank runs the model on its rows of the global batch and
computes the same, replicated loss:

- **global-batch negatives** (``cfg.parallel.global_batch_negatives``,
  the default): the features are all-gathered over the data group and the
  InfoNCE is the B_global x B_global one, padded rows masked by the
  gathered ``valid``;
- **per-shard negatives** (on more than one data shard): each rank's
  B_local x B_local block is its own InfoNCE; the loss and the four
  diagnostics are pooled by valid count over the data group, as the JAX
  package's ``_per_shard_infonce``;
- the LM cross-entropy and the attention regulariser are global means
  (their sums and counts all-reduced).

The collectives' backward passes sum every rank's gradient (``parallel/
collectives.py``), and the train step averages the parameter gradients
over the data group before the update, so every rank's update is the
world-1 update on the global batch. The vocab-sharded embedding's
gradient (its rank's rows) is averaged over the same group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.config import ExperimentConfig
from multimodal_baby_tpu_torch.core.constants import DATA_AXIS, PAD_TOKEN_ID
from multimodal_baby_tpu_torch.data.augment import augment_batch
from multimodal_baby_tpu_torch.models import losses as L
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.models.quant_calib import calibrate_cvcl
from multimodal_baby_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, reduce_gradients)
from multimodal_baby_tpu_torch.parallel.mesh import Mesh
from multimodal_baby_tpu_torch.train.optimizer import build_optimizer
from multimodal_baby_tpu_torch.train.profiler import span, wait

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    model: CVCL
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # augment and dropout draws, model's device
    step: int = 0  # train steps taken


# the generator's seed on data shard i: seed + i * DATA_SEED_STRIDE
DATA_SEED_STRIDE = 1_000_003


def init_train_state(model: CVCL, cfg: ExperimentConfig,
                     mesh: Mesh | None = None) -> TrainState:
    """Optimizer over the model's trainable parameters and a generator for
    the augment and the dropout, on the model's device, seeded with
    ``cfg.train.seed`` (on a mesh, plus ``DATA_SEED_STRIDE`` times the
    data coordinate: the ranks of one data group, which hold the same
    rows, draw the same; data shard 0 draws as one device does)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    shard = 0 if mesh is None else mesh.coordinate(DATA_AXIS)
    generator.manual_seed(cfg.train.seed + shard * DATA_SEED_STRIDE)
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
            with wait("staging_slot"):
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
    with span("device_batch"):
        device = torch.device(device)
        arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()
                  if k != "raw"}
        if device.type != "cuda":
            return {k: torch.from_numpy(v.astype(np.int64)
                                        if v.dtype == np.int32 else v
                                        ).to(device)
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


def make_loss_fn(model: CVCL, cfg: ExperimentConfig,
                 mesh: Mesh | None = None) -> Callable:
    """loss_fn(batch, train, generator) -> (loss, metrics). In training,
    ``generator`` draws the augment and the text encoder's dropout.

    ``batch`` holds ``text`` [B, L], ``text_len`` [B], optional ``valid``
    [B], and either ``image`` (normalized [B, H, W, 3]) or ``image_u8``
    (raw frames, augmented and normalized here on the device). The
    contrastive half runs when ``lambda_mm`` is nonzero or unused terms are
    not skipped (``optimize_unused`` False), the LM half likewise with
    ``lambda_lm``; the frames are read only when a half needs them. The
    augment's form is the model's kernel configuration's (``model.kernels``):
    with ``split_stem`` a ResNeXt trunk gets the space-to-depth layout in
    training and evaluation alike (the JAX package's ``MMB_SPLIT_STEM``),
    and ``aug_csplit`` resamples channel by channel. On a
    ``mesh`` with a process group, ``batch`` is this rank's rows and the
    loss and metrics are the global batch's (the module's docstring)."""
    t = cfg.train
    use_mm = bool(t.lambda_mm) or not t.optimize_unused
    use_lm = bool(t.lambda_lm) or not t.optimize_unused
    text_cfg = cfg.model.text
    needs_image = use_mm or (use_lm and (text_cfg.captioning
                                         or text_cfg.attention))
    compute_dtype = (torch.bfloat16
                     if cfg.parallel.compute_dtype == "bfloat16"
                     else torch.float32)
    s2d = (model.kernels.split_stem
           and cfg.model.vision.backbone == "resnext50")
    csplit = model.kernels.aug_csplit
    group = None if mesh is None else mesh.group(DATA_AXIS)
    per_shard = (not cfg.parallel.global_batch_negatives
                 and mesh is not None and mesh.shape[DATA_AXIS] > 1)

    def reduce(x):
        return all_reduce(x, group)

    def gather(x):
        return all_gather(x, group)

    def loss_fn(batch: Batch, train: bool,
                generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, Metrics]:
        image = None
        if needs_image and "image" in batch:
            image = batch["image"]
        elif needs_image:
            with span("augment"):
                image = augment_batch(
                    batch["image_u8"],
                    augment=cfg.data.augment_frames and train,
                    dtype=compute_dtype, generator=generator, s2d=s2d,
                    csplit=csplit)
        out = model.joint_forward(
            image, batch["text"], batch["text_len"], train=train,
            generator=generator, use_mm=use_mm, use_lm=use_lm,
            gather=gather if group is not None and not per_shard else None)
        with span("loss"):
            # a padded tail batch marks its real rows: they alone count
            valid = batch.get("valid")
            rows = (valid.sum().float() if valid is not None
                    else batch["text"].new_full((), batch["text"].shape[0],
                                                dtype=torch.float32))
            metrics: Metrics = {
                "batch_size": reduce(rows),
                "temperature": torch.exp(-out["logit_neg_log_temperature"]),
            }
            infonce = lm_ce = attn_reg = 0.0
            if use_mm:
                lpi, lpt = out["logits_per_image"], out["logits_per_text"]
                if per_shard:
                    infonce, m = L.contrastive_loss_from_logits(lpi, lpt,
                                                                valid=valid)
                    # pooled by valid count: the unsharded computation's
                    infonce = reduce(infonce * rows) / metrics["batch_size"]
                    m = {k: reduce(v.detach() * rows) / metrics["batch_size"]
                         for k, v in m.items()}
                else:  # the gathered rows' mask on a mesh
                    infonce, m = L.contrastive_loss_from_logits(
                        lpi, lpt, valid=(gather(valid) if valid is not None
                                         else None))
                metrics.update(m)
                metrics["infonce_loss"] = infonce
            if use_lm:
                labels = out["lm_labels"]
                if valid is not None:  # padded rows add no tokens
                    labels = torch.where(valid[:, None], labels, PAD_TOKEN_ID)
                ce, _ = L.lm_cross_entropy(out["lm_logits"], labels)
                breakdown = (L.lm_loss_breakdown(ce, labels) if group is None
                             else L.lm_loss_breakdown(ce, labels, reduce))
                metrics.update(breakdown)
                lm_ce = breakdown["ce_loss"]
                if text_cfg.attention and out.get("attns") is not None:
                    attn_reg = (L.attn_reg_loss(out["attns"]) if group is None
                                else L.attn_reg_loss(out["attns"], reduce))
                    metrics["attn_reg_loss"] = attn_reg
            loss = torch.as_tensor(t.lambda_mm * infonce + t.lambda_lm * lm_ce
                                   + t.lambda_ar * attn_reg)
            metrics["loss"] = loss
            return loss, metrics

    return loss_fn


def make_train_step(model: CVCL, cfg: ExperimentConfig,
                    mesh: Mesh | None = None
                    ) -> Callable[[TrainState, Batch], Metrics]:
    """Returns train_step(state, batch) -> metrics; updates the model's
    trainable parameters in place and counts the step. On a ``mesh`` the
    gradients are averaged over the data group before the update."""
    loss_fn = make_loss_fn(model, cfg, mesh)
    group = None if mesh is None else mesh.group(DATA_AXIS)

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        with span("train_step"):
            state.step += 1
            opt = state.optimizer
            opt.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(batch, True, state.generator)
            with span("backward"):
                loss.backward()
            with span("optimizer"):
                # optax's masked AdamW updates every trainable leaf, a zero
                # gradient included (its weight decay still applies);
                # torch's AdamW skips a parameter whose .grad is None.
                # Zero-filling keeps the two equal. It matters for
                # parameters outside the graph of the terms in use: e.g.
                # the vision head in the LM-only recipe, or the LM bias,
                # which decay shrinks when a checkpoint made it nonzero.
                params = [p for group_ in opt.param_groups
                          for p in group_["params"]]
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if group is not None:
                    reduce_gradients(params, group, mesh.shape[DATA_AXIS])
                opt.step()
                model.clip_logit_scale()
            return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: CVCL, cfg: ExperimentConfig,
                   mesh: Mesh | None = None
                   ) -> Callable[[Batch], Metrics]:
    """Validation step: loss and metrics, no gradients, no augment (on a
    ``mesh``, the global batch's, as the train step's)."""
    loss_fn = make_loss_fn(model, cfg, mesh)

    def eval_step(batch: Batch) -> Metrics:
        with torch.no_grad():
            _, metrics = loss_fn(batch, False)
        return metrics

    return eval_step
