"""CVCL dual encoder (counterpart of
``multimodal_baby_tpu/models/multimodal.py``): the contrastive half, with
flat similarity.

Parameter names follow the reference's Lightning checkpoint, so
``multimodal_baby_tpu/api/convert.py::convert_cvcl_checkpoint`` maps this
module's ``state_dict()`` to the JAX package's parameter tree:
``vision_encoder.model.{conv1,bn1,layerS.B.*,fc}`` (ResNeXt-50) or
``vision_encoder.model.{patch_embed,cls_token,pos_embed,blocks.*,norm,head}``
(ViT-B/14), ``text_encoder.{embedding.weight,transformer_encoder.*,
pos_embed}``, ``model.logit_neg_log_temperature``
(learned temperature only) and ``language_model.output_layer.{weight,bias}``
(weight only when untied). The LM head is held for the state dict and the
optimizer; the slice runs no LM forward.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.models.layers import resolve_device
from multimodal_baby_tpu_torch.models.text import TextEncoder
from multimodal_baby_tpu_torch.models.vision import VisionEncoder
from multimodal_baby_tpu_torch.models.vision_vit import ViTKernels


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||, 1e-12), torch F.normalize semantics."""
    return x / x.norm(dim=dim, keepdim=True).clamp_min(1e-12)


class LMOutputLayer(nn.Module):
    """The LM head's parameters under the reference's names. When tied, the
    kernel is the token embedding and only the bias lives here."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not cfg.tie:
            # flax initializers.uniform(2/sqrt(E)): U[0, 2/sqrt(E))
            w = torch.rand(cfg.vocab_size, cfg.embedding_dim,
                           generator=generator) * (2 / math.sqrt(
                               cfg.embedding_dim))
            self.weight = nn.Parameter(w.to(device))
        if cfg.bias:
            self.bias = nn.Parameter(
                torch.zeros(cfg.vocab_size, device=device))


class CVCL(nn.Module):
    """``dtype`` is the trunk's compute dtype (None = f32); parameters,
    heads, logits and losses stay f32. The model is built on the card
    unless ``device`` says otherwise (``device="cpu"``); asking for the card
    where there is none raises. ``generator`` is a CPU generator for the
    seeded init. ``fused_plan`` is the ResNeXt trunk's kernel plan (None:
    the JAX package's default), ``vit_kernels`` the ViT trunk's kernel
    configuration (None: ``ViTKernels()``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype | None = None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 fused_plan: Tuple[str, ...] | None = None,
                 vit_kernels: ViTKernels | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision_encoder = VisionEncoder(cfg, dtype, device=device,
                                            generator=generator,
                                            fused_plan=fused_plan,
                                            vit_kernels=vit_kernels)
        self.text_encoder = TextEncoder(cfg, device=device,
                                        generator=generator)
        init_val = -math.log(cfg.temperature)
        if cfg.fix_temperature:
            self.register_buffer(
                "fixed_neg_log_temperature",
                torch.tensor(init_val, dtype=torch.float32, device=device),
                persistent=False)
        else:
            self.model = nn.Module()
            self.model.logit_neg_log_temperature = nn.Parameter(
                torch.tensor(init_val, dtype=torch.float32, device=device))
        self.language_model = nn.Module()
        self.language_model.output_layer = LMOutputLayer(
            cfg, device=device, generator=generator)

    @property
    def logit_neg_log_temperature(self) -> torch.Tensor:
        if self.cfg.fix_temperature:
            return self.fixed_neg_log_temperature
        return self.model.logit_neg_log_temperature

    def encode_image(self, image: torch.Tensor, train: bool = False):
        features, feature_map = self.vision_encoder(image, train=train)
        if self.cfg.normalize_features:
            features = l2_normalize(features, dim=1)
        return features, feature_map

    def encode_text(self, text: torch.Tensor, text_length: torch.Tensor,
                    generator: torch.Generator | None = None):
        """``generator`` draws the text encoder's dropout (None:
        deterministic)."""
        features, outputs = self.text_encoder(text, text_length, generator)
        if self.cfg.normalize_features:
            features = l2_normalize(features, dim=-1)
        return features, outputs

    def similarity(self, image_features: torch.Tensor,
                   text_features: torch.Tensor) -> torch.Tensor:
        return image_features @ text_features.T

    def logit_scale(self) -> torch.Tensor:
        return self.logit_neg_log_temperature.exp()

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                text_length: torch.Tensor, train: bool = False,
                return_image_features: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        out = self.joint_forward(image, text, text_length, train=train)
        ret = (out["logits_per_image"], out["logits_per_text"])
        if return_image_features:
            ret = ret + (out["image_features"], out["image_feature_map"])
        return ret

    def joint_forward(self, image: torch.Tensor, text: torch.Tensor,
                      text_length: torch.Tensor, train: bool = False,
                      generator: torch.Generator | None = None
                      ) -> Dict[str, torch.Tensor]:
        """The contrastive outputs the train and eval steps need. In
        training, ``generator`` draws the text encoder's dropout; eval is
        deterministic."""
        image_features, image_feature_map = self.encode_image(
            image, train=train)
        text_features, text_outputs = self.encode_text(
            text, text_length, generator if train else None)
        match = self.similarity(image_features, text_features)
        scale = self.logit_scale()
        return {
            "logits_per_image": match * scale,
            "logits_per_text": match.T * scale,
            "image_features": image_features,
            "image_feature_map": image_feature_map,
            "text_outputs": text_outputs,
            "logit_neg_log_temperature": self.logit_neg_log_temperature,
        }
