"""VisionEncoder: trunk + projection head (counterpart of
``multimodal_baby_tpu/models/vision.py``).

The trunk is ResNeXt-50 (with the config's ``trunk_int8`` plan, and the
kernel plan, folded-path rule and stem of the ``KernelConfig``, by default
the JAX package's), DINO ViT-B/14 (with the ``KernelConfig``'s
``ViTKernels``, by default K5 + K6 with the erf GELU; its int8 and LN-fold
modes are refused when the trunk is fine-tuned, as in the JAX package),
CLIP ViT-L/14's vision tower (``cnn_model="clip_vit_l14"``, the port
only: ``models/clip.py::CLIPVisionTower``, K5 + K6 with CLIP's GELU, its
gradient through their ``PlainVJP`` when fine-tuned) or the test trunk
``TinyConvNet`` (``cnn_model="toy"``).
The head replaces the trunk's classifier with the projection, as in the
reference: ``model.fc`` on the ResNeXt and the toy trunk (2048 or 32 ->
E), ``model.head`` on the ViTs (768 -> E; on CLIP the bias-free visual
projection, 1024 -> E). For spatial embeddings (CNN
trunks only) the head maps every position of the feature map: a 1x1
convolution, which on the NHWC map is the same Linear on the channel
axis. A frozen trunk's outputs are
detached; its parameters leave autograd when
``train.optimizer.build_optimizer`` applies the frozen mask.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.models.clip import (
    CLIP_CONFIGS, CLIPVisionTower, clip_kernels, tower_configs)
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.layers import (
    TorchLinear, resolve_device)
from multimodal_baby_tpu_torch.models.vision_resnext import ResNeXt50
from multimodal_baby_tpu_torch.models.vision_vit import vit_base
from multimodal_baby_tpu_torch.train.profiler import span


# the trunks that give a class token and no feature map
_VITS = ("vit_b14", "clip_vit_l14")


class TinyConvNet(nn.Module):
    """The JAX package's minimal CNN trunk for tests and dry runs
    (``multimodal_baby_tpu/models/vision.py:28-41``): an 8x8 convolution
    of stride 8, ReLU, a 4x4 convolution of stride 4, ReLU, with flax's
    "SAME" padding, in f32 whatever the compute dtype (the JAX package
    gives it none). Same output contract as ``ResNeXt50``, 32 channels
    (``VisionConfig.last_out_dim``). Parameters ``conv{1,2}.{weight,bias}``
    (OIHW), init N(0, 1/fan_in), bias 0."""

    def __init__(self, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 8, stride=8, device=device)
        self.conv2 = nn.Conv2d(32, 32, 4, stride=4, device=device)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                w = conv.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        / math.sqrt(fan_in))
                conv.bias.zero_()

    @staticmethod
    def _same(x: torch.Tensor, k: int) -> torch.Tensor:
        """flax's "SAME" padding for a k x k window of stride k."""
        pads = []
        for n in (x.shape[3], x.shape[2]):  # W, then H (F.pad's order)
            total = max((-(-n // k) - 1) * k + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.pad(x, pads)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        y = x.float().permute(0, 3, 1, 2)
        y = torch.relu(self.conv1(self._same(y, 8)))
        y = torch.relu(self.conv2(self._same(y, 4)))
        fmap = y.permute(0, 2, 3, 1)
        return {"pooled": fmap.mean(dim=(1, 2)), "feature_map": fmap}


class VisionEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype | None = None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 kernels: KernelConfig | None = None):
        super().__init__()
        v = cfg.vision
        kernels = kernels or KernelConfig()
        if cfg.embedding_type not in ("flat", "spatial"):
            raise ValueError(f"embedding_type must be flat|spatial, got "
                             f"{cfg.embedding_type!r}")
        if cfg.embedding_type == "spatial" and v.backbone in _VITS:
            raise ValueError("spatial embeddings require the CNN backbone")
        if v.frozen_bn not in ("batch", "running"):
            raise ValueError(f"frozen_bn must be batch|running, got "
                             f"{v.frozen_bn!r}")
        device = resolve_device(device)
        self.cfg = cfg
        if v.backbone == "toy":
            self.model = TinyConvNet(device=device, generator=generator)
        elif v.backbone in CLIP_CONFIGS:
            _, tower, _ = tower_configs(CLIP_CONFIGS[v.backbone])
            self.model = CLIPVisionTower(
                tower, dtype or torch.float32,
                clip_kernels(kernels.vit, tower),
                frozen=not v.finetune_cnn, device=device)
        elif v.vit_dino:  # trunk_int8 is the ResNeXt's, as in the JAX package
            self.model = vit_base(dtype=dtype, frozen=not v.finetune_cnn,
                                  device=device, generator=generator,
                                  vit_kernels=kernels.vit)
        else:
            self.model = ResNeXt50(
                dtype=dtype, frozen=not v.finetune_cnn, device=device,
                generator=generator, trunk_int8=v.trunk_int8,
                fused_plan=kernels.trunk_plan,
                fused_trunk=kernels.fused_trunk, stem=kernels.stem,
                stem_cpad=kernels.stem_cpad)
        if v.backbone in CLIP_CONFIGS:
            head = nn.Linear(self.model.cfg.hidden_size, cfg.embedding_dim,
                             bias=False, device=device)
        else:
            head = TorchLinear(v.last_out_dim, cfg.embedding_dim,
                               device=device, generator=generator)
        if v.backbone in _VITS:
            self.model.head = head
        else:
            self.model.fc = head

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: [B, H, W, 3] NHWC, ImageNet-normalized. Returns
        (features [B, E] (flat) or [B, h, w, E] (spatial), feature_map
        [B, h, w, 2048]); the ViTs have no feature map (None), as in the
        reference."""
        v = self.cfg.vision
        if v.backbone in _VITS:
            if v.backbone in CLIP_CONFIGS:
                x = x.permute(0, 3, 1, 2)   # the CLIP tower reads NCHW
            with span("trunk"):
                cls = self.model(x)
            if not v.finetune_cnn:
                cls = cls.detach()
            return self.model.head(cls), None
        # a frozen trunk may run BN on running averages (frozen_bn="running")
        bn_train = train and (v.finetune_cnn or v.frozen_bn == "batch")
        with span("trunk"):
            out = self.model(x, train=bn_train)
        pooled, feature_map = out["pooled"], out["feature_map"]
        if not v.finetune_cnn:
            pooled = pooled.detach()
            feature_map = feature_map.detach()
        if self.cfg.embedding_type == "spatial":
            return self.model.fc(feature_map), feature_map
        return self.model.fc(pooled), feature_map
