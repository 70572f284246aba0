"""Training entry point (counterpart of ``multimodal_baby_tpu/cli/train.py``;
reference: train.py).

    python -m multimodal_baby_tpu_torch.cli.train --dataset saycam \\
        --data_dir data --cnn_dino --text_encoder embedding \\
        --embedding_dim 512 ... [--device cuda|cpu]

The reference's flag set (``cli/args.py``), seeding, the ``--fast_dev_run``
smoke mode and resume (``--resume_ckpt last`` or a checkpoint directory).
It trains on ``--device``, the card by default, in the kernel
configuration of the kernel flags (``cli/args.py::add_kernel_args``: one
per environment knob of the JAX package, e.g. ``--vit_int8 1`` for
``MMB_VIT_INT8=1``); a resumed run takes the flags it is given, not the
ones it was started with. ``--frozen_bn running``
with an int8 plan (``--trunk_int8 0,0,1,1``) and a batch that is a
multiple of 32 runs the train step's trunk through the published plan's
kernels; the default ``--frozen_bn batch`` runs it on batch statistics
(the conv path, as the reference does) and validation through the
kernels.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist

from multimodal_baby_tpu_torch.cli.args import (
    add_all_args, add_kernel_args, args_to_config, kernel_config_from_args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_all_args(parser)
    add_kernel_args(parser)
    parser.add_argument("--fast_dev_run", action="store_true",
                        help="one tiny epoch as a smoke test "
                             "(reference: run.sh:13)")
    parser.add_argument("--prepare_data_only", action="store_true",
                        help="run the offline ETL (idempotent, "
                             "resumable) and exit without training")
    return parser


def make_trainer(argv=None, step_timer=None):
    """Parse ``argv`` and build the ``Trainer`` (None after
    ``--prepare_data_only``); ``step_timer`` times its steps
    (``train/profiler.py::StepTimer``)."""
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    kernels = kernel_config_from_args(args)

    if args.fast_dev_run:
        cfg.train.max_epochs = 1
        cfg.data.synthetic_size = max(2 * cfg.data.batch_size, 8)

    from multimodal_baby_tpu_torch.data.modules import DataModule
    distributed = dist.is_available() and dist.is_initialized()
    if args.dataset in ("saycam", "coco") and (
            not distributed or dist.get_rank() == 0):
        DataModule(cfg.data, seed=cfg.train.seed).prepare_data()
    if distributed:
        dist.barrier()
    if args.prepare_data_only:
        print(f"prepare_data complete under {cfg.data.data_dir}")
        return None

    from multimodal_baby_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, device=args.device, step_timer=step_timer,
                      kernels=kernels)
    print(f"experiment {cfg.exp_name}: "
          f"{len(trainer.data.datasets['train'])} train examples, "
          f"vocab {trainer.data.vocab_size}, device {trainer.device}, "
          f"{trainer.mesh}")
    return trainer


def init_distributed(device: str) -> bool:
    """Initialise the default process group from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): ``nccl``
    for the card, ``gloo`` for the CPU. False (nothing done) outside
    torchrun or when a group exists."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    dist.init_process_group(
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    return True


def main(argv=None) -> Optional[dict]:
    device = build_parser().parse_args(argv).device
    started = init_distributed(device)
    try:
        trainer = make_trainer(argv)
        if trainer is None:
            return None
        result = trainer.fit()
        print("final:", result)
        return result
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
