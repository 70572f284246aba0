"""Weight bridges (counterpart of ``multimodal_baby_tpu/api/convert.py``).

``convert_resnext50``, ``convert_vit``, ``convert_text_encoder`` and
``convert_cvcl_checkpoint`` there turn a reference-named state dict into
flax ``(params, batch_stats)``; the functions here invert them, turning the
JAX package's trees (numpy arrays) into this package's ``state_dict``, so
both packages can run on the same weights. ``reference_state_dict`` maps
a reference Lightning checkpoint's state dict onto the port's names, which
are the reference's apart from the spatial variant's trunk.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.config import ModelConfig
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


def resnext50_state_dict(params: Tree, stats: Tree, prefix: str = "",
                         quant_scales: Tree | None = None
                         ) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_resnext50``: flax ResNeXt50 trees -> torchvision
    names under ``prefix``. ``quant_scales`` is the trunk's subtree of the
    JAX package's "quant_scales" collection (an int8 plan's activation
    ranges: ``stem_amax``, ``layerS_B/{h1_amax, h2_amax, out_amax}``); its
    entries become the port's amax buffers of the same names."""
    p = prefix
    sd: Dict[str, np.ndarray] = {f"{p}conv1.weight": _conv(
        params["conv1"]["kernel"])}
    _bn(sd, f"{p}bn1", params["bn1"], stats["bn1"])
    qs = quant_scales or {}
    if "stem_amax" in qs:
        sd[f"{p}stem_amax"] = np.asarray(qs["stem_amax"])
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
            for name, v in qs.get(f"layer{stage}_{b}", {}).items():
                sd[f"{tp}.{name}"] = np.asarray(v)
    return sd


def _linear(out: Dict[str, np.ndarray], prefix: str, p: Tree) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _ln(out: Dict[str, np.ndarray], prefix: str, p: Tree) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def vit_state_dict(params: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``convert_vit``: flax VisionTransformerDino tree ->
    reference names under ``prefix``."""
    p = prefix
    sd: Dict[str, np.ndarray] = {
        f"{p}cls_token": np.asarray(params["cls_token"]),
        f"{p}pos_embed": np.asarray(params["pos_embed"]),
        f"{p}patch_embed.proj.weight": _conv(
            params["patch_embed"]["kernel"]),
        f"{p}patch_embed.proj.bias": np.asarray(params["patch_embed"]["bias"]),
    }
    _ln(sd, f"{p}norm", params["norm"])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        bp, tp = params[f"block{i}"], f"{p}blocks.{i}"
        _ln(sd, f"{tp}.norm1", bp["norm1"])
        _ln(sd, f"{tp}.norm2", bp["norm2"])
        _linear(sd, f"{tp}.attn.qkv", bp["attn"]["qkv"])
        _linear(sd, f"{tp}.attn.proj", bp["attn"]["proj"])
        _linear(sd, f"{tp}.mlp.fc1", bp["fc1"])
        _linear(sd, f"{tp}.mlp.fc2", bp["fc2"])
    return sd


def text_encoder_state_dict(params: Tree, prefix: str = "text_encoder."
                            ) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_text_encoder`` (and its ``_lstm_dir``) for every
    text encoder: the token embedding, the LSTM directions (torch layout
    ``[4H, in]``, the backward one with the suffix ``_reverse``), the
    transformer layer and its learned pos-embed (reference layout
    ``[L, 1, E]``), the captioning ``connector``, the additive
    ``attention`` and its gate."""
    p = prefix
    sd = {f"{p}embedding.weight": np.asarray(params["token_embedding"])}
    for name, suffix in (("lstm_fwd", ""), ("lstm_bwd", "_reverse")):
        if name in params:
            lp = params[name]
            for w in ("weight_ih", "weight_hh"):
                sd[f"{p}lstm.{w}_l0{suffix}"] = np.asarray(lp[w]).T
            for b in ("bias_ih", "bias_hh"):
                sd[f"{p}lstm.{b}_l0{suffix}"] = np.asarray(lp[b])
    if "transformer_layer" in params:
        tl, lp = params["transformer_layer"], f"{p}transformer_encoder.layers.0"
        sd[f"{lp}.self_attn.in_proj_weight"] = np.asarray(
            tl["in_proj_weight"]).T
        sd[f"{lp}.self_attn.in_proj_bias"] = np.asarray(tl["in_proj_bias"])
        _linear(sd, f"{lp}.self_attn.out_proj", tl["out_proj"])
        _linear(sd, f"{lp}.linear1", tl["linear1"])
        _linear(sd, f"{lp}.linear2", tl["linear2"])
        _ln(sd, f"{lp}.norm1", tl["norm1"])
        _ln(sd, f"{lp}.norm2", tl["norm2"])
    if "pos_embed" in params:
        sd[f"{p}pos_embed"] = np.asarray(params["pos_embed"])[:, None]
    if "connector" in params:
        _linear(sd, f"{p}connector", params["connector"])
    for name in ("encoder_projection", "decoder_projection", "attn_layer"):
        if name in params.get("attention", {}):
            _linear(sd, f"{p}attention.{name}", params["attention"][name])
    if "attention_gate_projection" in params:
        _linear(sd, f"{p}attention_gate_projection",
                params["attention_gate_projection"])
    return sd


def cvcl_state_dict(params: Tree, batch_stats: Tree, vit: bool = False,
                    quant_scales: Tree | None = None
                    ) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_cvcl_checkpoint`` for the port's CVCL: a
    ResNeXt-50 (``vit=False``), toy (read from the tree) or ViT-B/14
    trunk, its head (flat or spatial: both a Linear ``fc``), the text
    encoder (read from the tree) and the LM head.
    ``quant_scales`` is the JAX model's "quant_scales" collection (an int8
    trunk plan's activation ranges)."""
    vis = params["vision_encoder"]
    vp = "vision_encoder.model."
    if vit:
        sd = vit_state_dict(vis["backbone"], vp)
        _linear(sd, f"{vp}head", vis["head"])
    elif "conv2" in vis["backbone"]:  # the toy trunk, TinyConvNet
        sd = {}
        for name in ("conv1", "conv2"):
            conv = vis["backbone"][name]
            sd[f"{vp}{name}.weight"] = _conv(conv["kernel"])
            sd[f"{vp}{name}.bias"] = np.asarray(conv["bias"])
        _linear(sd, f"{vp}fc", vis["head"])
    else:
        sd = resnext50_state_dict(
            vis["backbone"], batch_stats["vision_encoder"]["backbone"], vp,
            (quant_scales or {}).get("vision_encoder", {}).get("backbone"))
        _linear(sd, f"{vp}fc", vis["head"])
    sd.update(text_encoder_state_dict(params["text_encoder"]))
    if "logit_neg_log_temperature" in params:
        sd["model.logit_neg_log_temperature"] = np.asarray(
            params["logit_neg_log_temperature"])
    if "lm_kernel" in params:
        sd["language_model.output_layer.weight"] = np.asarray(
            params["lm_kernel"]).T
    if "lm_bias" in params:
        sd["language_model.output_layer.bias"] = np.asarray(params["lm_bias"])
    return sd


# the spatial variant wraps the ResNeXt in a Sequential
# (multimodal.py:182-185): its children by index, 8 the 1x1 head conv
_SEQUENTIAL = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4", "8": "fc"}


def reference_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """A reference Lightning checkpoint's state dict under the port's CVCL
    names for ``cfg`` (``multimodal_baby_tpu/api/convert.py:207-230`` and
    ``api/model.py:209-210``): the spatial variant's Sequential indices
    renamed and its 1x1 head conv made the Linear ``fc``; BatchNorm's
    ``num_batches_tracked`` dropped (the port's BN keeps no count); the
    learned temperature dropped under ``fix_temperature``; the LM head's
    weight dropped when tied (it is the token embedding) and its bias when
    ``bias`` is off. Every other key is kept, for a strict load."""
    vp = "vision_encoder.model."
    wrapped = (not cfg.vision.vit_dino and f"{vp}conv1.weight" not in sd)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.endswith(".num_batches_tracked"):
            continue
        if wrapped and k.startswith(vp):
            index, _, rest = k[len(vp):].partition(".")
            if index in _SEQUENTIAL:
                k = f"{vp}{_SEQUENTIAL[index]}.{rest}"
                if k == f"{vp}fc.weight":
                    v = v[:, :, 0, 0]
        out[k] = v
    if cfg.fix_temperature:
        out.pop("model.logit_neg_log_temperature", None)
    if cfg.tie:
        out.pop("language_model.output_layer.weight", None)
    if not cfg.bias:
        out.pop("language_model.output_layer.bias", None)
    return out


def load_state_dict(model: torch.nn.Module, sd: Mapping[str, np.ndarray]
                    ) -> None:
    """Copy numpy arrays into ``model``'s parameters and buffers in place;
    the key sets must match exactly."""
    model.load_state_dict(
        {k: torch.tensor(np.asarray(v, dtype=np.float32))
         for k, v in sd.items()}, strict=True)
