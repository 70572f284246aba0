"""Typed configuration: the same dataclasses, fields and defaults as
``multimodal_baby_tpu/core/config.py`` (a test holds the two equal), so a
config serialised by one package loads in the other. The port keeps its
own copy so that it imports nothing of the JAX package; the field comments
there are the documentation of each option.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class VisionConfig:
    pretrained_cnn: bool = True
    cnn_model: str = "resnext50"
    cnn_dino: bool = False
    vit_dino: bool = False
    finetune_cnn: bool = False
    # frozen-CNN BatchNorm mode during training: "batch" (the reference's
    # quirk: batch statistics) or "running"; eval always uses running
    frozen_bn: str = "batch"
    trunk_int8: Any = False

    @property
    def backbone(self) -> str:
        if self.cnn_model == "toy":
            return "toy"
        return "vit_b14" if self.vit_dino else "resnext50"

    @property
    def last_out_dim(self) -> int:
        if self.cnn_model == "toy":
            return 32
        return 768 if self.vit_dino else 2048


@dataclass
class TextConfig:
    text_encoder: str = "embedding"  # embedding|cbow|lstm|bilstm|transformer
    captioning: bool = False
    attention: bool = False
    attention_activation: str = "relu"
    attention_gate: bool = False
    crange: int = 1
    dropout_i: float = 0.0
    dropout_o: float = 0.0
    pos_embed_type: str = "no_pos_embed"

    @property
    def regressional(self) -> bool:
        return self.text_encoder == "lstm"


@dataclass
class ModelConfig:
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    embedding_type: str = "flat"  # flat|spatial
    embedding_dim: int = 128
    normalize_features: bool = False
    sim: str = "max"
    temperature: float = 0.07
    fix_temperature: bool = False
    tie: bool = True
    bias: bool = True
    vocab_size: int = 2350


@dataclass
class TrainConfig:
    optimizer: str = "AdamW"
    lr: float = 3e-4
    lr_scheduler: bool = False
    factor: float = 0.1
    patience: int = 20
    weight_decay: float = 0.01
    lambda_mm: float = 1.0
    lambda_lm: float = 0.0
    lambda_ar: float = 0.0
    optimize_unused: bool = False
    eval_textgen: bool = False
    beam_width: int = 3
    decode_length: int = 25
    length_penalty_alpha: float = 0.0
    max_epochs: int = 100
    seed: int = 0
    val_every_n_epochs: int = 1
    checkpoint_dir: str = "checkpoints"
    save_top_k: int = 1
    resume_ckpt: Optional[str] = None
    log_every_n_steps: int = 50
    logger: str = "jsonl"


@dataclass
class DataConfig:
    dataset: str = "saycam"
    data_dir: str = "data"
    batch_size: int = 4
    drop_last: bool = False
    val_batch_size: int = 16
    num_workers: int = 4
    augment_frames: bool = False
    eval_include_sos_eos: bool = False
    test_while_val: bool = False
    eval_type: str = "image"
    eval_metadata_filename: str = "eval_filtered_dev.json"
    clip_eval: bool = False
    multiple_frames: bool = False
    shuffle_utterances: bool = False
    transcript_dir: Optional[str] = None
    video_dir: Optional[str] = None
    labeled_s_dir: Optional[str] = None
    transcript_links_csv: Optional[str] = None
    synthetic_size: int = 1024


@dataclass
class ParallelConfig:
    mesh_shape: Tuple[int, int] = (-1, 1)
    global_batch_negatives: bool = True
    # precision policy: params f32, compute bf16, logits f32
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    f32_eval: bool = False
    remat_vision: bool = False


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    exp_name: str = "default"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_dict(d: dict) -> "ExperimentConfig":
        def build(cls, sub: dict):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in sub:
                    continue
                v = sub[f.name]
                if f.name in _SUBCONFIGS:
                    v = build(_SUBCONFIGS[f.name], v)
                elif f.name == "mesh_shape":
                    v = tuple(v)
                kwargs[f.name] = v
            return cls(**kwargs)

        return build(ExperimentConfig, d)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        return ExperimentConfig.from_dict(json.loads(s))


_SUBCONFIGS = {
    "model": ModelConfig,
    "data": DataConfig,
    "train": TrainConfig,
    "parallel": ParallelConfig,
    "vision": VisionConfig,
    "text": TextConfig,
}
