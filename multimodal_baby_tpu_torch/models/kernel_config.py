"""The kernel configuration of a run: every mode that the JAX package reads
from an ``MMB_*`` environment variable, as one frozen value, checked when
it is made and handed to the model when the model is built
(``models/multimodal.py::CVCL(kernels=...)``). Nothing in the port reads
these variables.

    field         the JAX package's knob         default
    trunk_plan    MMB_TRUNK_PLAN                  banded28,blocks,split,full
    fused_trunk   MMB_FUSED_TRUNK                 None: the folded ResNeXt
                                                  path on the card when it
                                                  applies
    vit           MMB_FUSED_ATTN, MMB_VIT_MLP,    ViTKernels(): K5 + K6, erf
                  MMB_VIT_BLOCK, MMB_VIT_GELU,
                  MMB_VIT_INT8, MMB_VIT_LNFOLD
    fused_lstm    MMB_FUSED_LSTM                  None: the length rule
    stem          MMB_S2D_STEM ("s2d")            "conv7"
    stem_cpad     MMB_STEM_CPAD                   False
    split_stem    MMB_SPLIT_STEM                  False
    aug_csplit    MMB_AUG_CSPLIT                  False

The int8 stages of the ResNeXt (``MMB_TRUNK_INT8``) are
``VisionConfig.trunk_int8``, as in the JAX package. The defaults are the
JAX package's. A checkpoint does not record the configuration: a resumed
or loaded model takes the one it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from multimodal_baby_tpu_torch.models.layers import check_fused_lstm
from multimodal_baby_tpu_torch.models.vision_resnext import (
    DEFAULT_PLAN, check_stem, parse_fused_plan)
from multimodal_baby_tpu_torch.models.vision_vit import ViTKernels


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """``trunk_plan``: the ResNeXt stages' kernel modes (a 4-tuple,
    ``vision_resnext.parse_fused_plan``). ``fused_trunk``: the
    ResNeXt's folded path always (True; refused where it does not apply),
    never (False) or on the card where it applies (None). ``vit``: the
    ViT's ``ViTKernels``. ``fused_lstm``: the LSTM recurrence kernel's rule
    (``models/layers.py::use_fused_lstm``). ``stem``: the ResNeXt's stem,
    "conv7" (the 7x7 stride-2 convolution) or "s2d" (its 4x4 stride-1
    space-to-depth form, bf16 only); ``stem_cpad``: its input channels
    zero-padded (3 -> 8, or 12 -> 16). ``split_stem``: the train and eval
    steps hand a ResNeXt trunk the augment's space-to-depth layout
    directly; ``aug_csplit``: the augment resamples channel by channel.
    Unknown values raise ValueError."""

    trunk_plan: Tuple[str, ...] = DEFAULT_PLAN
    fused_trunk: Optional[bool] = None
    vit: ViTKernels = ViTKernels()
    fused_lstm: Optional[bool] = None
    stem: str = "conv7"
    stem_cpad: bool = False
    split_stem: bool = False
    aug_csplit: bool = False

    def __post_init__(self):
        object.__setattr__(self, "trunk_plan",
                           parse_fused_plan(self.trunk_plan))
        if not (self.fused_trunk is None
                or isinstance(self.fused_trunk, bool)):
            raise ValueError(f"KernelConfig.fused_trunk must be None, True "
                             f"or False, got {self.fused_trunk!r}")
        if not isinstance(self.vit, ViTKernels):
            raise ValueError(f"KernelConfig.vit must be a ViTKernels, got "
                             f"{self.vit!r}")
        check_fused_lstm(self.fused_lstm)
        check_stem(self.stem)
        for name in ("stem_cpad", "split_stem", "aug_csplit"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"KernelConfig.{name} must be a bool, got "
                                 f"{getattr(self, name)!r}")
