"""Rank workers for ``tests/test_torch_parallel.py``: gloo process groups on
the CPU, each rank a process spawned with ``torch.multiprocessing``.

This module imports neither JAX nor the JAX package, so that the spawned
children, which import it to find their target, do not either. The
process group meets through a ``file://`` store (no TCP port: pytest-xdist
workers run such tests side by side). The jobs' inputs (configs as JSON,
weights and batches as numpy) go to the ranks in a file, and each rank
saves its results with ``torch.save`` for the parent to read.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_baby_tpu_torch.api.convert import load_state_dict
from multimodal_baby_tpu_torch.core.config import ExperimentConfig
from multimodal_baby_tpu_torch.core.constants import DATA_AXIS
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.parallel.collectives import reduce_gradients
from multimodal_baby_tpu_torch.parallel.mesh import create_mesh, shard_batch
from multimodal_baby_tpu_torch.parallel.vocab import (
    EMBEDDING, full_model_state, shard_vocab)
from multimodal_baby_tpu_torch.train.step import (
    device_batch, init_train_state, make_loss_fn, make_train_step)


def build(cfg_json, state, mesh_shape):
    """The config, a CVCL on the CPU with ``state`` (reference names,
    numpy) loaded, the mesh and its vocab shard."""
    cfg = ExperimentConfig.from_json(cfg_json)
    cfg.parallel.mesh_shape = tuple(mesh_shape)
    model = CVCL(cfg.model, device="cpu")
    load_state_dict(model, state)
    mesh = create_mesh(cfg.parallel.mesh_shape)
    return cfg, model, mesh, shard_vocab(model, mesh)


def loss_job(cfg_json, state, batch, mesh_shape, pad_to=None):
    """The loss and metrics of this rank's rows (eval mode) and every
    parameter's gradient after the data-group average (the sharded
    embedding's gathered whole); then one AdamW train step's trainable
    parameters (gathered whole)."""
    cfg, model, mesh, shard = build(cfg_json, state, mesh_shape)
    local = device_batch(shard_batch(mesh, batch, pad_to), "cpu")
    loss, metrics = make_loss_fn(model, cfg, mesh)(local, False)
    loss.backward()
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    reduce_gradients([p for _, p in named], mesh.group(DATA_AXIS),
                     mesh.shape[DATA_AXIS])
    grads = {n: (shard.gather(p.grad) if shard is not None and n == EMBEDDING
                 else p.grad).numpy().copy() for n, p in named}

    cfg, model, mesh, shard = build(cfg_json, state, mesh_shape)
    train_state = init_train_state(model, cfg, mesh)
    make_train_step(model, cfg, mesh)(train_state, dict(local))
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    trained = {k: v.numpy().copy() for k, v in full_model_state(model).items()
               if k in trainable}
    return {"loss": loss.item(), "rows": int(local["text"].shape[0]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "trained": trained}


def trainer_job(cfg_json, mesh_shape):
    """Fit the trainer for ``cfg.train.max_epochs`` on this rank; its
    logged records and the full trained state."""
    from multimodal_baby_tpu_torch.train.trainer import Trainer
    cfg = ExperimentConfig.from_json(cfg_json)
    cfg.parallel.mesh_shape = tuple(mesh_shape)
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    log = Path(trainer.logger.path)
    return {"records": [json.loads(line) for line in
                        log.read_text().splitlines()],
            "log": log.name,
            "state": {k: v.numpy().copy() for k, v in
                      full_model_state(trainer.model).items()}}


JOBS = {"loss": loss_job, "trainer": trainer_job}


def _rank(rank, world, store, out):
    torch.set_num_threads(1)
    jobs = torch.load(os.path.join(out, "jobs.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        results = {name: JOBS[kind](**kw) for name, (kind, kw)
                   in jobs.items()}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Spawned:
    """Ranks started by ``spawn``; ``results()`` waits for them and
    returns each rank's {job name: result}."""

    def __init__(self, context, tmp: Path, world: int):
        self.context, self.tmp, self.world = context, tmp, world

    def results(self):
        while not self.context.join():
            pass
        return [torch.load(self.tmp / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def spawn(world, jobs, tmp) -> Spawned:
    """Start ``jobs`` ({name: (kind, kwargs)}, run in order) on ``world``
    gloo ranks without waiting for them."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    # the jobs go by file: arguments pickled into the children's pipes
    # would make each start wait for the previous child's imports
    torch.save(jobs, tmp / "jobs.pt")
    context = mp.spawn(_rank, args=(world, str(tmp / "store"), str(tmp)),
                       nprocs=world, join=False)
    return Spawned(context, tmp, world)
