"""Weight bridge from the JAX package (counterpart of
``multimodal_baby_tpu/api/convert.py``, run the other way).

``convert_resnext50`` and ``convert_cvcl_checkpoint`` there turn a
reference-named state dict into flax ``(params, batch_stats)``; the
functions here invert them, turning the JAX package's trees (numpy arrays)
into this package's ``state_dict``, so both packages can run on the same
weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from multimodal_baby_tpu_torch.models.vision_resnext import RESNEXT50_STAGES

Tree = Mapping[str, object]


def _conv(kernel) -> np.ndarray:
    """flax HWIO -> torch OIHW (also for grouped convs)."""
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _bn(out: Dict[str, np.ndarray], prefix: str, params: Tree,
        stats: Tree) -> None:
    out[f"{prefix}.weight"] = np.asarray(params["scale"])
    out[f"{prefix}.bias"] = np.asarray(params["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
    out[f"{prefix}.running_var"] = np.asarray(stats["var"])


def resnext50_state_dict(params: Tree, stats: Tree, prefix: str = ""
                         ) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_resnext50``: flax ResNeXt50 trees -> torchvision
    names under ``prefix``."""
    p = prefix
    sd: Dict[str, np.ndarray] = {f"{p}conv1.weight": _conv(
        params["conv1"]["kernel"])}
    _bn(sd, f"{p}bn1", params["bn1"], stats["bn1"])
    for stage, (_, n_blocks, _) in enumerate(RESNEXT50_STAGES, start=1):
        for b in range(n_blocks):
            bp = params[f"layer{stage}_{b}"]
            bs = stats[f"layer{stage}_{b}"]
            tp = f"{p}layer{stage}.{b}"
            for i in (1, 2, 3):
                sd[f"{tp}.conv{i}.weight"] = _conv(bp[f"conv{i}"]["kernel"])
                _bn(sd, f"{tp}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
            if "downsample_conv" in bp:
                sd[f"{tp}.downsample.0.weight"] = _conv(
                    bp["downsample_conv"]["kernel"])
                _bn(sd, f"{tp}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])
    return sd


def cvcl_state_dict(params: Tree, batch_stats: Tree
                    ) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_cvcl_checkpoint`` for the slice's CVCL
    (ResNeXt-50 trunk, flat head, embedding text encoder)."""
    vis = params["vision_encoder"]
    sd = resnext50_state_dict(vis["backbone"],
                              batch_stats["vision_encoder"]["backbone"],
                              "vision_encoder.model.")
    sd["vision_encoder.model.fc.weight"] = np.asarray(vis["head"]["kernel"]).T
    sd["vision_encoder.model.fc.bias"] = np.asarray(vis["head"]["bias"])
    sd["text_encoder.embedding.weight"] = np.asarray(
        params["text_encoder"]["token_embedding"])
    if "logit_neg_log_temperature" in params:
        sd["model.logit_neg_log_temperature"] = np.asarray(
            params["logit_neg_log_temperature"])
    if "lm_kernel" in params:
        sd["language_model.output_layer.weight"] = np.asarray(
            params["lm_kernel"]).T
    if "lm_bias" in params:
        sd["language_model.output_layer.bias"] = np.asarray(params["lm_bias"])
    return sd


def load_state_dict(model: torch.nn.Module, sd: Mapping[str, np.ndarray]
                    ) -> None:
    """Copy numpy arrays into ``model``'s parameters and buffers in place;
    the key sets must match exactly."""
    model.load_state_dict(
        {k: torch.tensor(np.asarray(v, dtype=np.float32))
         for k, v in sd.items()}, strict=True)
