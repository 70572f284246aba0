"""VisionEncoder: trunk + projection head (counterpart of
``multimodal_baby_tpu/models/vision.py``).

The trunk is ResNeXt-50 (with the config's ``trunk_int8`` plan and the
kernel plan ``fused_plan``, by default the JAX package's) or DINO
ViT-B/14 (with the kernel configuration ``vit_kernels``, by default K5 +
K6 with the erf GELU). The head replaces the trunk's classifier with the projection, as
in the reference: ``model.fc`` on the ResNeXt (2048 -> E), ``model.head``
on the ViT (768 -> E). For spatial embeddings (ResNeXt only) the head maps
every position of the feature map: a 1x1 convolution, which on the NHWC
map is the same Linear on the channel axis. A frozen trunk's outputs are
detached; its parameters leave autograd when
``train.optimizer.build_optimizer`` applies the frozen mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.models.layers import (
    TorchLinear, resolve_device)
from multimodal_baby_tpu_torch.models.vision_resnext import (
    DEFAULT_PLAN, ResNeXt50)
from multimodal_baby_tpu_torch.models.vision_vit import ViTKernels, vit_base


class VisionEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype | None = None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 fused_plan: Tuple[str, ...] | None = None,
                 vit_kernels: ViTKernels | None = None):
        super().__init__()
        v = cfg.vision
        if v.backbone not in ("resnext50", "vit_b14"):
            raise NotImplementedError(
                "the port's vision trunks are ResNeXt-50 and ViT-B/14; got "
                f"{v.backbone!r}")
        if cfg.embedding_type not in ("flat", "spatial"):
            raise ValueError(f"embedding_type must be flat|spatial, got "
                             f"{cfg.embedding_type!r}")
        if cfg.embedding_type == "spatial" and v.vit_dino:
            raise ValueError("spatial embeddings require the CNN backbone")
        if v.frozen_bn not in ("batch", "running"):
            raise ValueError(f"frozen_bn must be batch|running, got "
                             f"{v.frozen_bn!r}")
        device = resolve_device(device)
        self.cfg = cfg
        if v.vit_dino:  # trunk_int8 is the ResNeXt's, as in the JAX package
            self.model = vit_base(dtype=dtype, frozen=not v.finetune_cnn,
                                  device=device, generator=generator,
                                  vit_kernels=vit_kernels)
        else:
            self.model = ResNeXt50(
                dtype=dtype, frozen=not v.finetune_cnn, device=device,
                generator=generator, trunk_int8=v.trunk_int8,
                fused_plan=fused_plan or DEFAULT_PLAN)
        head = TorchLinear(v.last_out_dim, cfg.embedding_dim, device=device,
                           generator=generator)
        if v.vit_dino:
            self.model.head = head
        else:
            self.model.fc = head

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: [B, H, W, 3] NHWC, ImageNet-normalized. Returns
        (features [B, E] (flat) or [B, h, w, E] (spatial), feature_map
        [B, h, w, 2048]); the ViT has no feature map (None), as in the
        reference."""
        v = self.cfg.vision
        if v.vit_dino:
            cls = self.model(x)
            if not v.finetune_cnn:
                cls = cls.detach()
            return self.model.head(cls), None
        # a frozen trunk may run BN on running averages (frozen_bn="running")
        bn_train = train and (v.finetune_cnn or v.frozen_bn == "batch")
        out = self.model(x, train=bn_train)
        pooled, feature_map = out["pooled"], out["feature_map"]
        if not v.finetune_cnn:
            pooled = pooled.detach()
            feature_map = feature_map.detach()
        if self.cfg.embedding_type == "spatial":
            return self.model.fc(feature_map), feature_map
        return self.model.fc(pooled), feature_map
