"""Argparse <-> typed-config bridge (counterpart of
``multimodal_baby_tpu/cli/args.py``: the same flags, defaults and config,
which a test holds equal, plus ``--device``).

The flag set of the reference's argparse registry (composed in
train.py:18-55 from each component's ``add_to_argparse``) and the JAX
package's scaling flags. Parsing produces an ``ExperimentConfig``.
``--mesh d,m`` lays the ranks of a ``torchrun`` launch out as d data
shards by m vocab shards (``parallel/mesh.py``); without ``torchrun`` the
world is one device, and ``--per_shard_negatives`` changes nothing on one
data shard, as in the JAX package.

``add_kernel_args`` adds the kernel configuration's flags, one for each
environment knob of the JAX package (``--fused_attn`` for
``MMB_FUSED_ATTN``, and so on; the same values), to every entry point that
builds a model; ``kernel_config_from_args`` makes the
``models/kernel_config.py::KernelConfig`` of them. Their defaults are the
JAX package's.
"""

from __future__ import annotations

import argparse

from multimodal_baby_tpu_torch.core.config import (
    DataConfig, ExperimentConfig, ModelConfig, ParallelConfig, TextConfig,
    TrainConfig, VisionConfig)
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.vision_resnext import DEFAULT_PLAN
from multimodal_baby_tpu_torch.models.vision_vit import (
    ATTN_MODES, MLP_MODES, ViTKernels)
from multimodal_baby_tpu_torch.ops.vit_common import GELU_MODES

OFF_ON = ("0", "1")
AUTO = {"auto": None, "0": False, "1": True}


def _bool_expr(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes")


def add_all_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # --- vision encoder (multimodal.py:74-86) ---
    g = parser.add_argument_group("vision")
    g.add_argument("--pretrained_cnn", action="store_true")
    g.add_argument("--cnn_model", type=str, default="resnext50")
    g.add_argument("--cnn_dino", action="store_true")
    g.add_argument("--vit_dino", action="store_true")
    g.add_argument("--finetune_cnn", action="store_true")
    # framework knobs (no reference counterpart)
    g.add_argument("--frozen_bn", type=str, default="batch",
                   choices=["batch", "running"],
                   help="BatchNorm mode for the frozen trunk during "
                   "training: 'batch' reproduces the reference quirk, "
                   "'running' runs the trunk's kernels in the train step")
    g.add_argument("--trunk_int8", nargs="?", const=True, default=False,
                   help="int8-quantized fused trunk (frozen trunks; "
                   "ops/quant.py, activation ranges calibrated). Bare "
                   "flag = whole trunk; an optional per-stage plan like "
                   "'0,0,1,1' (the published recipe's) runs int8 on a "
                   "suffix of stages only")

    # --- text encoder (multimodal.py:366-389) ---
    g = parser.add_argument_group("text")
    g.add_argument("--text_encoder", type=str, default="embedding",
                   choices=["embedding", "cbow", "lstm", "bilstm",
                            "transformer"])
    g.add_argument("--captioning", action="store_true")
    g.add_argument("--attention", action="store_true")
    g.add_argument("--attention_activation", type=str, default="relu",
                   choices=["relu", "tanh"])
    g.add_argument("--attention_gate", action="store_true")
    g.add_argument("--crange", type=int, default=1)
    g.add_argument("--dropout_i", type=float, default=0.0)
    g.add_argument("--dropout_o", type=float, default=0.0)
    g.add_argument("--pos_embed_type", type=str, default="no_pos_embed",
                   choices=["no_pos_embed", "sinusoidal", "learned"])

    # --- multimodal head (multimodal.py:717-730) ---
    g = parser.add_argument_group("model")
    g.add_argument("--embedding_type", type=str, default="flat",
                   choices=["spatial", "flat"])
    g.add_argument("--embedding_dim", type=int, default=128)
    g.add_argument("--normalize_features", action="store_true")
    g.add_argument("--sim", type=str, default="max",
                   choices=["mean", "max"])
    g.add_argument("--temperature", type=float, default=0.07)
    g.add_argument("--fix_temperature", action="store_true")

    # --- language model (multimodal.py:838-843) ---
    # a bare flag means True: the sweep runner (cli/runner.py) emits a
    # grid's True as the bare flag (configs/saycam_lm.py: tie, bias)
    g.add_argument("--tie", type=_bool_expr, nargs="?", const=True,
                   default=True)
    g.add_argument("--bias", type=_bool_expr, nargs="?", const=True,
                   default=True)

    # --- optimization (multimodal_lit.py:76-110) ---
    g = parser.add_argument_group("train")
    g.add_argument("--optimizer", type=str, default="AdamW")
    g.add_argument("--lr", type=float, default=3e-4)
    g.add_argument("--lr_scheduler", action="store_true")
    g.add_argument("--factor", type=float, default=0.1)
    g.add_argument("--patience", type=int, default=20)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--lambda_mm", type=float, default=1.0)
    g.add_argument("--lambda_lm", type=float, default=0.0)
    g.add_argument("--lambda_ar", type=float, default=0.0)
    g.add_argument("--optimize_unused", action="store_true")
    g.add_argument("--eval_textgen", action="store_true")
    g.add_argument("--beam_width", type=int, default=3)
    g.add_argument("--decode_length", type=int, default=25)
    g.add_argument("--length_penalty_alpha", type=float, default=0.0)
    g.add_argument("--max_epochs", type=int, default=100)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    g.add_argument("--save_top_k", type=int, default=1)
    g.add_argument("--resume_ckpt", type=str, default=None,
                   help='"last" resumes from <checkpoint_dir>/<exp>/last')
    g.add_argument("--log_every_n_steps", type=int, default=50)
    g.add_argument("--logger", type=str, default="jsonl",
                   choices=["jsonl", "wandb", "none"])
    g.add_argument("--exp_name", type=str, default="default")

    # --- data module (multimodal_data_module.py:282-311 + saycam) ---
    g = parser.add_argument_group("data")
    g.add_argument("--dataset", type=str, default="saycam",
                   choices=["saycam", "coco", "object_categories",
                            "synthetic"])
    g.add_argument("--data_dir", type=str, default="data")
    g.add_argument("--batch_size", type=int, default=4)
    g.add_argument("--drop_last", action="store_true")
    g.add_argument("--val_batch_size", type=int, default=16)
    g.add_argument("--num_workers", type=int, default=4)
    g.add_argument("--augment_frames", action="store_true")
    g.add_argument("--eval_include_sos_eos", action="store_true")
    g.add_argument("--test_while_val", action="store_true")
    g.add_argument("--eval_type", type=str, default="image",
                   choices=["image", "text"])
    g.add_argument("--eval_metadata_filename", type=str,
                   default="eval_filtered_dev.json")
    g.add_argument("--clip_eval", action="store_true")
    g.add_argument("--multiple_frames", action="store_true")
    g.add_argument("--shuffle_utterances", action="store_true")
    g.add_argument("--synthetic_size", type=int, default=1024,
                   help="train examples of --dataset synthetic (the port's "
                        "flag; the JAX package sets it in code only)")
    # raw-input staging for prepare_data (ETL; reference
    # multimodal_saycam_data_module.py:159-176)
    g.add_argument("--transcript_dir", type=str, default=None)
    g.add_argument("--video_dir", type=str, default=None)
    g.add_argument("--labeled_s_dir", type=str, default=None)
    g.add_argument("--transcript_links_csv", type=str, default=None)

    # --- devices and scaling ---
    g = parser.add_argument_group("parallel")
    g.add_argument("--device", type=str, default="cuda",
                   help="the device to train on (the card by default)")
    g.add_argument("--mesh", type=str, default="-1,1",
                   help="data,model mesh shape (e.g. 4,2) over the ranks "
                        "of a torchrun launch; -1 = all")
    g.add_argument("--per_shard_negatives", action="store_true",
                   help="independent InfoNCE per data shard "
                        "(small-batch recipe parity at scale)")
    g.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    return parser


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    mesh = tuple(int(x) for x in args.mesh.split(","))
    return ExperimentConfig(
        exp_name=args.exp_name,
        model=ModelConfig(
            vision=VisionConfig(
                pretrained_cnn=args.pretrained_cnn,
                cnn_model=args.cnn_model,
                cnn_dino=args.cnn_dino,
                vit_dino=args.vit_dino,
                finetune_cnn=args.finetune_cnn,
                frozen_bn=args.frozen_bn,
                trunk_int8=args.trunk_int8),
            text=TextConfig(
                text_encoder=args.text_encoder,
                captioning=args.captioning,
                attention=args.attention,
                attention_activation=args.attention_activation,
                attention_gate=args.attention_gate,
                crange=args.crange,
                dropout_i=args.dropout_i,
                dropout_o=args.dropout_o,
                pos_embed_type=args.pos_embed_type),
            embedding_type=args.embedding_type,
            embedding_dim=args.embedding_dim,
            normalize_features=args.normalize_features,
            sim=args.sim,
            temperature=args.temperature,
            fix_temperature=args.fix_temperature,
            tie=args.tie,
            bias=args.bias),
        data=DataConfig(
            dataset=args.dataset,
            data_dir=args.data_dir,
            batch_size=args.batch_size,
            drop_last=args.drop_last,
            val_batch_size=args.val_batch_size,
            num_workers=args.num_workers,
            augment_frames=args.augment_frames,
            eval_include_sos_eos=args.eval_include_sos_eos,
            test_while_val=args.test_while_val,
            eval_type=args.eval_type,
            eval_metadata_filename=args.eval_metadata_filename,
            clip_eval=args.clip_eval,
            multiple_frames=args.multiple_frames,
            shuffle_utterances=args.shuffle_utterances,
            synthetic_size=args.synthetic_size,
            transcript_dir=args.transcript_dir,
            video_dir=args.video_dir,
            labeled_s_dir=args.labeled_s_dir,
            transcript_links_csv=args.transcript_links_csv),
        train=TrainConfig(
            optimizer=args.optimizer,
            lr=args.lr,
            lr_scheduler=args.lr_scheduler,
            factor=args.factor,
            patience=args.patience,
            weight_decay=args.weight_decay,
            lambda_mm=args.lambda_mm,
            lambda_lm=args.lambda_lm,
            lambda_ar=args.lambda_ar,
            optimize_unused=args.optimize_unused,
            eval_textgen=args.eval_textgen,
            beam_width=args.beam_width,
            decode_length=args.decode_length,
            length_penalty_alpha=args.length_penalty_alpha,
            max_epochs=args.max_epochs,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            save_top_k=args.save_top_k,
            resume_ckpt=args.resume_ckpt,
            log_every_n_steps=args.log_every_n_steps,
            logger=args.logger),
        parallel=ParallelConfig(
            mesh_shape=mesh,
            global_batch_negatives=not args.per_shard_negatives,
            compute_dtype=args.compute_dtype))


def add_kernel_args(parser: argparse.ArgumentParser
                    ) -> argparse.ArgumentParser:
    """The kernel configuration's flags, each named after the JAX package's
    environment knob and taking its values (README, "Kernel
    configuration")."""
    g = parser.add_argument_group("kernels")
    g.add_argument("--trunk_plan", type=str, default=",".join(DEFAULT_PLAN),
                   help="MMB_TRUNK_PLAN: the ResNeXt stages' kernel modes")
    g.add_argument("--fused_trunk", choices=sorted(AUTO), default="auto",
                   help="MMB_FUSED_TRUNK: the folded ResNeXt path always "
                   "(1), never (0), or on the card where it applies (auto)")
    g.add_argument("--fused_attn", choices=sorted(ATTN_MODES),
                   default="block", help="MMB_FUSED_ATTN: the ViT attention")
    g.add_argument("--vit_mlp", choices=sorted(MLP_MODES), default="fused",
                   help="MMB_VIT_MLP: the ViT MLP kernel (K6) or off")
    g.add_argument("--vit_block", choices=OFF_ON, default="0",
                   help="MMB_VIT_BLOCK: the whole ViT block in one kernel")
    g.add_argument("--vit_gelu", choices=GELU_MODES, default="erf",
                   help="MMB_VIT_GELU: the ViT MLP's GELU form")
    g.add_argument("--vit_int8", choices=OFF_ON, default="0",
                   help="MMB_VIT_INT8: the ViT block Denses in int8 "
                   "(frozen trunk)")
    g.add_argument("--vit_lnfold", choices=OFF_ON, default="0",
                   help="MMB_VIT_LNFOLD: LayerNorm's affine folded into qkv "
                   "and fc1 (frozen trunk)")
    g.add_argument("--fused_lstm", choices=sorted(AUTO), default="auto",
                   help="MMB_FUSED_LSTM: the LSTM recurrence kernel always "
                   "(1), never (0), or by the length rule (auto)")
    g.add_argument("--s2d_stem", choices=OFF_ON, default="0",
                   help="MMB_S2D_STEM: the ResNeXt stem as a 4x4 "
                   "space-to-depth convolution (bf16)")
    g.add_argument("--stem_cpad", choices=OFF_ON, default="0",
                   help="MMB_STEM_CPAD: the stem's input channels "
                   "zero-padded (3 -> 8, 12 -> 16)")
    g.add_argument("--split_stem", choices=OFF_ON, default="0",
                   help="MMB_SPLIT_STEM: the augment emits the "
                   "space-to-depth layout for the ResNeXt stem")
    g.add_argument("--aug_csplit", choices=OFF_ON, default="0",
                   help="MMB_AUG_CSPLIT: the augment resamples channel by "
                   "channel")
    return parser


def kernel_config_from_args(args: argparse.Namespace) -> KernelConfig:
    """The ``KernelConfig`` of ``add_kernel_args``'s flags."""
    return KernelConfig(
        trunk_plan=tuple(args.trunk_plan.split(",")),
        fused_trunk=AUTO[args.fused_trunk],
        vit=ViTKernels(attn=args.fused_attn, mlp=args.vit_mlp,
                       whole_block=args.vit_block == "1",
                       gelu=args.vit_gelu, int8=args.vit_int8 == "1",
                       lnfold=args.vit_lnfold == "1"),
        fused_lstm=AUTO[args.fused_lstm],
        stem="s2d" if args.s2d_stem == "1" else "conv7",
        stem_cpad=args.stem_cpad == "1",
        split_stem=args.split_stem == "1",
        aug_csplit=args.aug_csplit == "1")
