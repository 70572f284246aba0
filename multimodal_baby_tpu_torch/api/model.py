"""The public CVCL API, the five-call surface (counterpart of
``multimodal_baby_tpu/api/model.py``; reference: MultiModalLitModel,
multimodal_lit.py:130-190):

    model, preprocess = load_model("path/to/cvcl.ckpt")
    tokens, token_len = model.tokenize(["ball", "a cat"])
    image_features = model.encode_image(images)
    text_features = model.encode_text(tokens, token_len)
    logits_per_image, logits_per_text = model(images, tokens, token_len)

Inputs may be numpy arrays or tensors; outputs are tensors on the model's
device. The model is built on the card unless the caller passes
``device="cpu"``, in the kernel configuration ``kernels``
(``models/kernel_config.py``; None: the JAX package's defaults), which no
checkpoint records. A reference checkpoint's trunk runs in bf16 on the card
(a ResNeXt through its kernel plan) and in f32 elsewhere; a trainer's
checkpoint directory's in the compute dtype it trained in.

Checkpoint sources: a reference PyTorch Lightning ``.ckpt``, and a
checkpoint directory of the port's own trainer (``train/trainer.py``).
The JAX package also loads its trainer's (orbax) directories and downloads
the published "cvcl" checkpoint from the Hugging Face hub; the port refuses
both, with a message.

The bundled ``data/vocab.json`` is the published SAYCam vocabulary (2350
entries), a byte-for-byte copy of the JAX package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_baby_tpu_torch.api.convert import reference_state_dict
from multimodal_baby_tpu_torch.core.config import (
    ExperimentConfig, ModelConfig, TextConfig, VisionConfig)
from multimodal_baby_tpu_torch.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD, IMAGE_H, IMAGE_W, SPECIAL_TOKENS)
from multimodal_baby_tpu_torch.data.tokenizer import Tokenizer
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.layers import resolve_device
from multimodal_baby_tpu_torch.models.multimodal import CVCL

PACKAGED_VOCAB = Path(__file__).parent.parent / "data" / "vocab.json"
PUBLISHED = "cvcl_s_dino_resnext50_embedding"


def preprocess(pil_image) -> np.ndarray:
    """PIL image -> [224, 224, 3] float32, ImageNet-normalized (bicubic
    resize): the reference's published preprocess
    (multimodal_lit.py:143-148)."""
    from PIL import Image
    img = pil_image.convert("RGB").resize(
        (IMAGE_W, IMAGE_H), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return ((x - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))


class CVCLModel:
    """A CVCL with its weights, vocabulary and tokenizer. The four model
    calls run without autograd, in the model's eval semantics (running
    BatchNorm, no dropout)."""

    def __init__(self, model: CVCL, vocab: Vocab,
                 cfg: ExperimentConfig | None = None):
        self.model = model
        self.vocab = vocab
        self.cfg = cfg or ExperimentConfig(model=model.cfg)
        self.device = next(model.parameters()).device
        self._tokenizer = Tokenizer(vocab)

    def _to(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    # ---- the five public calls ----

    def tokenize(self, texts: Union[str, Sequence[str]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """texts -> (token ids [N, 25], true lengths [N]), int64."""
        ids, lens = self._tokenizer(texts)
        return self._to(ids, torch.long), self._to(lens, torch.long)

    @torch.no_grad()
    def encode_image(self, images) -> torch.Tensor:
        """images: [B, 224, 224, 3] float32, already preprocessed."""
        return self.model.encode_image(self._to(images, torch.float32))[0]

    @torch.no_grad()
    def encode_text(self, tokens, token_len=None) -> torch.Tensor:
        tokens = self._to(tokens, torch.long)
        if token_len is None:
            token_len = (tokens != 0).sum(dim=-1)
        return self.model.encode_text(tokens,
                                      self._to(token_len, torch.long))[0]

    @torch.no_grad()
    def __call__(self, images, tokens, token_len
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.model(self._to(images, torch.float32),
                          self._to(tokens, torch.long),
                          self._to(token_len, torch.long))[:2]

    # ---- constructors ----

    @staticmethod
    def from_checkpoint_dir(ckpt_dir, which: str = "best",
                            allow_placeholder_vocab: bool = False, *,
                            device="cuda",
                            kernels: KernelConfig | None = None
                            ) -> "CVCLModel":
        """Load a checkpoint directory of the port's trainer: its
        ``config.json`` makes the model (the trunk in the compute dtype it
        trained in, with its int8 plan and amax buffers), and the weights
        of the ``which`` ("best", else "last") checkpoint load strictly.

        The checkpoint's vocab_size is authoritative; the first word table
        of that size among the checkpoint directory's, ``data_dir``'s and
        the packaged one is used. Without one, loading fails (tokenize
        would be meaningless) unless ``allow_placeholder_vocab`` asks for
        a synthetic ``<w{i}>`` table (embeddings only), as in the JAX
        package (``multimodal_baby_tpu/api/model.py:97-163``). A directory
        the JAX package's trainer wrote (orbax) is refused."""
        from multimodal_baby_tpu_torch.train.checkpoint import (
            CheckpointManager)
        device = resolve_device(device)
        ckpt_dir = Path(ckpt_dir)
        if not (ckpt_dir / "config.json").exists():
            raise ValueError(f"{ckpt_dir} is not a checkpoint directory: "
                             "it has no config.json")
        cfg = CheckpointManager.load_config(ckpt_dir)
        candidates = [p for p in (ckpt_dir / "vocab.json",
                                  Path(cfg.data.data_dir) / "vocab.json",
                                  PACKAGED_VOCAB) if p.exists()]
        tables = [Vocab.load(p) for p in candidates]
        vocab = next((v for v in tables
                      if len(v) == cfg.model.vocab_size),
                     tables[-1] if tables else Vocab({}))
        if len(vocab) != cfg.model.vocab_size:
            if not allow_placeholder_vocab:
                raise ValueError(
                    f"checkpoint was trained with vocab_size="
                    f"{cfg.model.vocab_size} but the available word table "
                    f"({candidates[-1] if candidates else PACKAGED_VOCAB}) "
                    f"has {len(vocab)} entries; tokenization would be "
                    f"meaningless. Place the training vocab.json under "
                    f"{cfg.data.data_dir} or pass "
                    f"allow_placeholder_vocab=True to load with a "
                    f"synthetic vocab (embeddings only).")
            words = list(SPECIAL_TOKENS) + [
                f"<w{i}>" for i in range(cfg.model.vocab_size - 4)]
            vocab = Vocab({w: i for i, w in enumerate(words)})

        mgr = CheckpointManager(ckpt_dir)
        path = mgr.best_path() if which == "best" else mgr.last_path()
        if path is None:
            path = mgr.last_path()
        if path is None:
            raise ValueError(f"{ckpt_dir} holds no checkpoint")
        state = mgr.restore(path, map_location=device)
        dtype = (torch.bfloat16 if cfg.parallel.compute_dtype == "bfloat16"
                 else None)
        model = CVCL(cfg.model, dtype, device=device, kernels=kernels)
        model.load_state_dict(state["model"], strict=True)
        return CVCLModel(model, vocab, cfg)

    @staticmethod
    def from_torch_checkpoint(ckpt_path, text_encoder: str | None = None,
                              vocab_path=None, *, device="cuda",
                              kernels: KernelConfig | None = None
                              ) -> "CVCLModel":
        """Load a reference PyTorch Lightning checkpoint: its hparams make
        the ``ModelConfig`` (``multimodal_baby_tpu/api/model.py:177-205``),
        the vocabulary (``vocab_path``, else the packaged one) sets
        ``vocab_size``, and the state dict loads strictly after
        ``reference_state_dict``. The trunk computes in bf16 on the card
        (a ResNeXt through its default kernel plan, without int8 stages:
        a reference checkpoint holds no activation ranges) and in f32
        elsewhere."""
        device = resolve_device(device)
        # a Lightning checkpoint pickles its hparams: load only files you trust
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
        hparams = ckpt.get("hyper_parameters", ckpt.get("hparams", {})) or {}

        text_arch = text_encoder or hparams.get("text_encoder", "embedding")
        cfg = ModelConfig(
            embedding_dim=int(hparams.get("embedding_dim", 512)),
            embedding_type=hparams.get("embedding_type", "flat"),
            normalize_features=bool(hparams.get("normalize_features", True)),
            sim=hparams.get("sim", "max"),
            temperature=float(hparams.get("temperature", 0.07)),
            fix_temperature=bool(hparams.get("fix_temperature", True)),
            tie=bool(hparams.get("tie", True)),
            bias=bool(hparams.get("bias", True)),
            vision=VisionConfig(
                cnn_dino=bool(hparams.get("cnn_dino", True)),
                vit_dino=bool(hparams.get("vit_dino", False))),
            text=TextConfig(
                text_encoder=text_arch,
                captioning=bool(hparams.get("captioning", False)),
                attention=bool(hparams.get("attention", False)),
                attention_activation=hparams.get(
                    "attention_activation", "relu"),
                attention_gate=bool(hparams.get("attention_gate", False)),
                crange=int(hparams.get("crange", 1)),
                pos_embed_type=hparams.get(
                    "pos_embed_type", "no_pos_embed")))
        vocab = Vocab.load(vocab_path or PACKAGED_VOCAB)
        cfg.vocab_size = len(vocab)
        dtype = torch.bfloat16 if device.type == "cuda" else None
        model = CVCL(cfg, dtype, device=device, kernels=kernels)
        model.load_state_dict(
            {k: torch.as_tensor(v).float()
             for k, v in reference_state_dict(sd, cfg).items()},
            strict=True)
        return CVCLModel(model, vocab, ExperimentConfig(model=cfg))


def load_model(model_name: str = "cvcl", device="cuda",
               kernels: KernelConfig | None = None):
    """Returns (model, preprocess) like the reference
    (multimodal_lit.py:133-149), for a path to a local reference ``.ckpt``
    or to a checkpoint directory of the port's trainer, the model in the
    kernel configuration ``kernels``. Refuses the published name "cvcl" (a
    download from the Hugging Face hub)."""
    p = Path(model_name)
    if p.is_dir():
        return (CVCLModel.from_checkpoint_dir(p, device=device,
                                              kernels=kernels), preprocess)
    if p.exists():
        return (CVCLModel.from_torch_checkpoint(p, device=device,
                                                kernels=kernels), preprocess)
    if model_name == "cvcl":
        raise RuntimeError(
            f'load_model("cvcl") downloads wkvong/{PUBLISHED} from the '
            "Hugging Face hub, which the port does not do: download "
            f"{PUBLISHED}.ckpt and pass its path")
    raise ValueError(f"Model name not found: {model_name}")
