"""Training entry point (counterpart of ``multimodal_baby_tpu/cli/train.py``;
reference: train.py).

    python -m multimodal_baby_tpu_torch.cli.train --dataset saycam \\
        --data_dir data --cnn_dino --text_encoder embedding \\
        --embedding_dim 512 ... [--device cuda|cpu]

The reference's flag set (``cli/args.py``), seeding, the ``--fast_dev_run``
smoke mode and resume (``--resume_ckpt last`` or a checkpoint directory).
It trains on ``--device``, the card by default. ``--frozen_bn running``
with an int8 plan (``--trunk_int8 0,0,1,1``) and a batch that is a
multiple of 32 runs the train step's trunk through the published plan's
kernels; the default ``--frozen_bn batch`` runs it on batch statistics
(the conv path, as the reference does) and validation through the
kernels.
"""

from __future__ import annotations

import argparse
from typing import Optional

from multimodal_baby_tpu_torch.cli.args import add_all_args, args_to_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_all_args(parser)
    parser.add_argument("--fast_dev_run", action="store_true",
                        help="one tiny epoch as a smoke test "
                             "(reference: run.sh:13)")
    parser.add_argument("--prepare_data_only", action="store_true",
                        help="check the data directory and exit without "
                             "training (the ETL from raw inputs is not "
                             "ported)")
    return parser


def make_trainer(argv=None, step_timer=None):
    """Parse ``argv`` and build the ``Trainer`` (None after
    ``--prepare_data_only``); ``step_timer`` times its steps
    (``train/profiler.py::StepTimer``)."""
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)

    if args.fast_dev_run:
        cfg.train.max_epochs = 1
        cfg.data.synthetic_size = max(2 * cfg.data.batch_size, 8)

    from multimodal_baby_tpu_torch.data.modules import DataModule
    if args.dataset in ("saycam", "coco"):
        DataModule(cfg.data, seed=cfg.train.seed).prepare_data()
    if args.prepare_data_only:
        print(f"prepare_data complete under {cfg.data.data_dir}")
        return None

    from multimodal_baby_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, device=args.device, step_timer=step_timer)
    print(f"experiment {cfg.exp_name}: "
          f"{len(trainer.data.datasets['train'])} train examples, "
          f"vocab {trainer.data.vocab_size}, device {trainer.device}")
    return trainer


def main(argv=None) -> Optional[dict]:
    trainer = make_trainer(argv)
    if trainer is None:
        return None
    result = trainer.fit()
    print("final:", result)
    return result


if __name__ == "__main__":
    main()
