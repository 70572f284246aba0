"""The training loop: epochs, validation (joint loss + forced-choice
trials), plateau LR, checkpointing, resume, logging (counterpart of
``multimodal_baby_tpu/train/trainer.py``; reference: train.py:58-107 and
the MultiModalLitModel hooks).

One device: the loader's threads decode each batch (the native decoder,
``data/native``, or PIL where it is not built), the host loop copies its uint8 frames and
token ids to the card through a ring of pinned slots
(``train/step.py::HostStaging``) without waiting for the card, and the
train step augments, normalizes and runs the model there. A step's
metrics stay on the device until the epoch ends, as the JAX package's
deferred ``to_host``: the host reads nothing back inside an epoch (a
``StepTimer`` synchronizes each step when one is given), so it prepares
the next batch while the card runs the last.

With ``eval_textgen`` and an LM term (``lambda_lm``), the validation
also beam-decodes the split (``evaluation/textgen.py``) and logs BLEU-1..4,
METEOR, ROUGE_L, CIDEr and SPICE under the split's prefix, as the JAX
package's ``validate`` does (``multimodal_baby_tpu/train/trainer.py:
235-251``).

More than one device: under ``torchrun`` (a process group initialised,
``cli/train.py``) the trainer takes the (data, model) mesh from
``cfg.parallel.mesh_shape`` and the world size (``parallel/mesh.py``),
each rank on ``cuda:{LOCAL_RANK}``. Every rank's loader orders the
train set from the same seed and decodes only its rows of each global
batch; the train and eval steps compute the global batch's loss and
metrics (``train/step.py``). Forced choice and text generation, which the
JAX trainer runs outside its mesh, run on rank 0 with the full token
embedding, and their results are broadcast, so every rank logs the same
epoch metrics (rank 0 to ``metrics.jsonl``, rank r to
``metrics.rank{r}.jsonl``). Rank 0 writes the checkpoints, with a
vocab-sharded embedding and its optimizer moments gathered first, so a
checkpoint is the same file at any mesh shape and resumes at any other.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from multimodal_baby_tpu_torch.core.config import ExperimentConfig
from multimodal_baby_tpu_torch.core.constants import DATA_AXIS
from multimodal_baby_tpu_torch.data.augment import augment_batch
from multimodal_baby_tpu_torch.data.loader import DataLoader
from multimodal_baby_tpu_torch.data.modules import DataModule
from multimodal_baby_tpu_torch.evaluation.forced_choice import (
    run_forced_choice)
from multimodal_baby_tpu_torch.evaluation.textgen import run_textgen_eval
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.layers import resolve_device
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.parallel.collectives import broadcast_object
from multimodal_baby_tpu_torch.parallel.mesh import create_mesh, local_device
from multimodal_baby_tpu_torch.parallel.vocab import (
    full_model_state, full_optimizer_state, load_full_model_state,
    load_full_optimizer_state, shard_vocab, unsharded)
from multimodal_baby_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_baby_tpu_torch.train.metrics import (
    MetricsLogger, aggregate_epoch, to_host)
from multimodal_baby_tpu_torch.train.optimizer import (
    ReduceLROnPlateau, get_learning_rate, set_learning_rate)
from multimodal_baby_tpu_torch.train.profiler import StepTimer
from multimodal_baby_tpu_torch.train.step import (
    DATA_SEED_STRIDE, HostStaging, calibrate_trunk, device_batch,
    init_train_state, make_eval_step, make_train_step)

CALIB_FRAMES = 32  # trainer.py:101: the int8 ranges' sample


class Trainer:
    """``device``: where the model trains (the card unless the caller asks
    for another one; "cuda" is ``cuda:{LOCAL_RANK}`` under a process
    group). ``step_timer``: when given, each train step is timed to the end
    of its device work (a synchronization per step). ``kernels``: the
    model's kernel configuration (``models/kernel_config.py``; None: the
    JAX package's defaults). A checkpoint does not record it: a resumed run
    takes the one it is given."""

    def __init__(self, cfg: ExperimentConfig,
                 data: Optional[DataModule] = None, device="cuda",
                 step_timer: Optional[StepTimer] = None,
                 kernels: Optional[KernelConfig] = None):
        self.cfg = cfg
        self.mesh = create_mesh(cfg.parallel.mesh_shape)
        self.rank = self.mesh.rank
        self.device = resolve_device(local_device(device))
        self.data = data or DataModule(
            cfg.data, vocab_size_hint=cfg.model.vocab_size,
            seed=cfg.train.seed).setup()
        cfg.model.vocab_size = self.data.vocab_size

        dtype = {"bfloat16": torch.bfloat16, "float32": None}[
            cfg.parallel.compute_dtype]
        self.model = CVCL(cfg.model, dtype, device=self.device,
                          generator=torch.Generator().manual_seed(
                              cfg.train.seed), kernels=kernels)
        shard_vocab(self.model, self.mesh)

        self.ckpt = CheckpointManager(
            Path(cfg.train.checkpoint_dir) / cfg.exp_name,
            save_top_k=cfg.train.save_top_k)
        # the checkpoint directory holds the training vocab, so that
        # from_checkpoint_dir never has to guess a word table
        if self.data.vocab is not None and self.rank == 0:
            vocab_path = self.ckpt.dir / "vocab.json"
            if not vocab_path.exists():
                self.data.vocab.save(vocab_path)
        self.logger = MetricsLogger(
            Path(cfg.train.checkpoint_dir) / cfg.exp_name,
            filename=("metrics.jsonl" if self.rank == 0
                      else f"metrics.rank{self.rank}.jsonl"),
            use_wandb=cfg.train.logger == "wandb" and self.rank == 0,
            wandb_kwargs={"project": "multimodal-saycam-tpu",
                          "config": cfg.to_json()})
        self.plateau = ReduceLROnPlateau(cfg.train.factor,
                                         cfg.train.patience)
        self.start_epoch = 0
        self.step_timer = step_timer
        self.staging = HostStaging()  # the pinned slots of the H2D copies
        self.loader_wait_s = 0.0  # the last train epoch's wait on batches
        self._build()

    # ------------------------------------------------------------------

    def _build(self):
        cfg = self.cfg
        self.state = init_train_state(self.model, cfg, self.mesh)
        self._calib_batch = None
        trunk = self.model.vision_encoder.model
        if any(getattr(trunk, "int8_plan", ())):
            # the int8 ranges, on the first frames of the first unshuffled
            # batch with the augment off (trainer.py:95-108)
            loader = DataLoader(self.data.datasets["train"],
                                cfg.data.batch_size, shuffle=False,
                                sync=True)
            frames = next(iter(loader))["image_u8"][:CALIB_FRAMES]
            self._calib_batch = {"image": augment_batch(
                torch.from_numpy(frames).to(self.device), augment=False)}
            calibrate_trunk(self.model, self._calib_batch)
        self.train_step = make_train_step(self.model, cfg, self.mesh)
        self.eval_step = make_eval_step(self.model, cfg, self.mesh)

        if cfg.train.resume_ckpt:
            self._resume(cfg.train.resume_ckpt)

    def _resume(self, which: str):
        if which == "last":
            restored, _ = self.ckpt.restore_last(self.device)
        else:
            restored = self.ckpt.restore(which, self.device)
        if restored is None:
            print("no checkpoint to resume from; starting fresh")
            return
        load_full_model_state(self.model, restored["model"])
        load_full_optimizer_state(self.state.optimizer, self.model,
                                  restored["optimizer"])
        self.state.step = int(restored["step"])
        # the file holds data shard 0's generator; the other shards reseed
        # from the seed, their coordinate and the step
        shard = self.mesh.coordinate(DATA_AXIS)
        if shard == 0:
            self.state.generator.set_state(restored["generator"].cpu())
        else:
            self.state.generator.manual_seed(
                self.cfg.train.seed + shard * DATA_SEED_STRIDE
                + self.state.step)
        self.plateau.load_state_dict(restored["plateau"])
        self.start_epoch = int(restored["epoch"]) + 1
        set_learning_rate(self.state.optimizer, float(restored["lr"]))
        if self._calib_batch is not None:
            self._recalibrate()
        print(f"resumed from epoch {self.start_epoch - 1}")

    def _recalibrate(self):
        """Measure the int8 activation ranges again on the restored
        weights: those from ``_build`` belong to the seed's network."""
        calibrate_trunk(self.model, self._calib_batch)

    def _checkpoint_tree(self, epoch: int) -> dict:
        """Everything a resume restores: the model's state dict (the int8
        amax buffers included), the optimizer's state, the generator's
        state, the step, the plateau, the epoch and the LR; a vocab-sharded
        embedding and its moments gathered whole (every rank calls it)."""
        return {"model": full_model_state(self.model),
                "optimizer": full_optimizer_state(self.state.optimizer,
                                                  self.model),
                "generator": self.state.generator.get_state(),
                "step": self.state.step,
                "plateau": self.plateau.state_dict(),
                "epoch": epoch,
                "lr": get_learning_rate(self.state.optimizer)}

    # ------------------------------------------------------------------

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        loader = DataLoader(
            self.data.datasets["train"], cfg.data.batch_size,
            shuffle=True, drop_last=cfg.data.drop_last,
            num_workers=cfg.data.num_workers,
            seed=cfg.train.seed * 10000 + epoch, mesh=self.mesh,
            pad_to=cfg.data.batch_size)
        timer = self.step_timer
        device_outputs: List[Dict] = []
        self.loader_wait_s = 0.0
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.loader_wait_s += time.perf_counter() - t0
            if batch is None:
                break
            if timer is not None:
                timer.start()
            metrics = self.train_step(
                self.state, device_batch(batch, self.device, self.staging))
            if timer is not None:
                timer.stop(self.device)
            device_outputs.append(metrics)
        outputs = [to_host(m) for m in device_outputs]
        for step_idx, host in enumerate(outputs):
            if step_idx % cfg.train.log_every_n_steps == 0:
                self.logger.log(
                    host, self.state.step - len(outputs) + step_idx + 1,
                    prefix="train_")
        agg = aggregate_epoch(outputs)
        self.logger.log(agg, self.state.step, prefix="train_epoch_")
        return agg

    def validate(self, split: str = "val") -> Dict[str, float]:
        cfg = self.cfg
        out: Dict[str, float] = {}
        dataset = self.data.datasets.get(split)
        if dataset is not None:
            loader = DataLoader(dataset, cfg.data.val_batch_size,
                                shuffle=False,
                                num_workers=cfg.data.num_workers,
                                mesh=self.mesh,
                                pad_to=cfg.data.val_batch_size)
            outputs = [self.eval_step(device_batch(batch, self.device,
                                                   self.staging))
                       for batch in loader]
            out.update(aggregate_epoch([to_host(m) for m in outputs]))
        # what the JAX trainer runs outside its mesh runs on rank 0, with
        # the whole token embedding; every rank gets its results
        with unsharded(self.model, on_this_rank=self.rank == 0):
            one = self._validate_one_device(split, dataset) \
                if self.rank == 0 else None
        out.update(broadcast_object(one))
        self.logger.log(out, self.state.step, prefix=f"{split}_")
        return out

    def _validate_one_device(self, split: str, dataset) -> Dict[str, float]:
        """Text generation and forced choice on this rank alone."""
        cfg = self.cfg
        out: Dict[str, float] = {}
        if cfg.train.eval_textgen and cfg.train.lambda_lm \
                and dataset is not None:
            loader = DataLoader(dataset, cfg.data.val_batch_size,
                                shuffle=False,
                                num_workers=cfg.data.num_workers)
            scores, _, _ = run_textgen_eval(
                self.model, loader, self.data.vocab,
                beam_width=cfg.train.beam_width,
                decode_length=cfg.train.decode_length,
                length_penalty_alpha=cfg.train.length_penalty_alpha,
                captioning=cfg.model.text.captioning)
            out.update(scores)

        eval_ds = self.data.eval_datasets.get(split)
        if eval_ds is not None:
            accs, _ = run_forced_choice(self.model, eval_ds,
                                        cfg.data.eval_type)
            out["accuracy"] = accs["total"]
            for cat, acc in accs.items():
                if cat != "total":
                    out[f"accuracy_{cat}"] = acc
        return out

    # ------------------------------------------------------------------

    def fit(self) -> Dict[str, float]:
        cfg = self.cfg
        last_val: Dict[str, float] = {}
        for epoch in range(self.start_epoch, cfg.train.max_epochs):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch)
            if (epoch + 1) % cfg.train.val_every_n_epochs == 0:
                last_val = self.validate("val")
                val_loss = last_val.get("loss", float("inf"))
                if cfg.train.lr_scheduler:
                    lr = get_learning_rate(self.state.optimizer)
                    new_lr = self.plateau.step(val_loss, lr)
                    if new_lr != lr:
                        set_learning_rate(self.state.optimizer, new_lr)
                        print(f"plateau: lr {lr:.2e} -> {new_lr:.2e}")
                tree = self._checkpoint_tree(epoch)
                if self.rank == 0:
                    self.ckpt.save(tree, epoch, val_loss, cfg)
            if cfg.data.test_while_val and \
                    (epoch + 1) % cfg.train.val_every_n_epochs == 0:
                self.validate("test")
            dt = time.time() - t0
            if self.rank == 0:
                print(f"epoch {epoch}: train_loss="
                      f"{train_metrics.get('loss', float('nan')):.4f} "
                      f"val_loss={last_val.get('loss', float('nan')):.4f} "
                      f"val_acc={last_val.get('accuracy', float('nan')):.3f} "
                      f"({dt:.1f}s, {self.loader_wait_s:.2f}s waiting on "
                      f"the loader)")
        self.ckpt.wait()
        return last_val
