"""Pretrained vision-backbone loading from a local checkpoint (counterpart
of ``multimodal_baby_tpu/api/backbones.py``; reference:
multimodal/utils.py:145-214).

The self-supervised SAYCam backbones are published as torch state dicts
named like ``dino_sfp_resnext50`` or ``dino_sfp_vitb14`` (dino/mugs/mae x
say/s/sfp x resnext50/vitb14/...). The names parse as in the JAX package;
the file is read from ``checkpoint_path`` (a download from the Hugging Face
hub is refused, as ``api/model.py::load_model("cvcl")`` is), unwrapped
and prefix-stripped, and returned under the port's trunk names, which are
the reference's: torchvision's ``conv1, bn1, layerS.B.*`` for the
ResNeXt-50, ``patch_embed.proj, cls_token, pos_embed, blocks.i.*, norm``
for the ViT. ``load_backbone`` copies it into a CVCL's trunk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

SPEC_TO_ARCH = {
    "resnext50": ("resnext50", None),
    "vitb14": ("vit_base", 14),
    "vitl16": ("vit_large", 16),
    "vitb16": ("vit_base", 16),
    "vits16": ("vit_small", 16),
}
_DEPTH = {"vit_base": 12, "vit_small": 12, "vit_large": 24}


def parse_backbone_name(model_name: str) -> Tuple[str, str, str]:
    """'dino_sfp_resnext50' -> (alg='dino', data='sfp', spec='resnext50')
    (reference: multimodal/utils.py:145-163)."""
    alg, data, spec = model_name.split("_", 2)
    assert alg in ("dino", "mugs", "mae"), f"unknown algorithm {alg}"
    assert spec in SPEC_TO_ARCH, f"unrecognized architecture {spec}"
    return alg, data, spec


def _read(checkpoint_path) -> object:
    """``torch.load`` on the CPU, tensors only where the file allows it (a
    file that pickles other objects, such as DINO's argparse namespace,
    needs the full unpickler: read only files you trust)."""
    try:
        return torch.load(checkpoint_path, map_location="cpu",
                          weights_only=True)
    except Exception:
        return torch.load(checkpoint_path, map_location="cpu",
                          weights_only=False)


def load_backbone_state_dict(model_name: str,
                             checkpoint_path: Optional[str] = None) -> Dict:
    """The unwrapped torch state dict of a local checkpoint: the first of
    ``model_state_dict``, ``state_dict``, ``teacher``, ``model`` found is
    descended into, in that order, then the prefixes ``module.``,
    ``teacher.`` and ``backbone.`` are stripped. Without
    ``checkpoint_path`` (the JAX package downloads
    ``eminorhan/<model_name>`` from the hub) it refuses."""
    if checkpoint_path is None:
        raise RuntimeError(
            f"backbone {model_name!r} without a checkpoint_path is a "
            f"download of eminorhan/{model_name} from the Hugging Face hub, "
            f"which the port does not do: download {model_name}.pth and "
            "pass its path")
    ckpt = _read(checkpoint_path)
    for key in ("model_state_dict", "state_dict", "teacher", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    sd = {k: v for k, v in ckpt.items()}
    for prefix in ("module.", "teacher.", "backbone."):
        if any(k.startswith(prefix) for k in sd):
            sd = {(k[len(prefix):] if k.startswith(prefix) else k): v
                  for k, v in sd.items()}
    return sd


def _resnext50_keys(sd) -> list:
    """The keys ``convert_resnext50`` reads: the stem, and per block the
    three convs and BNs and the downsample where the file has one."""
    keys = ["conv1.weight"] + _bn_keys("bn1")
    for stage, n_blocks in ((1, 3), (2, 4), (3, 6), (4, 3)):
        for b in range(n_blocks):
            tp = f"layer{stage}.{b}"
            for i in (1, 2, 3):
                keys += [f"{tp}.conv{i}.weight"] + _bn_keys(f"{tp}.bn{i}")
            if f"{tp}.downsample.0.weight" in sd:
                keys += [f"{tp}.downsample.0.weight"] + _bn_keys(
                    f"{tp}.downsample.1")
    return keys


def _bn_keys(prefix: str) -> list:
    return [f"{prefix}.{n}" for n in ("weight", "bias", "running_mean",
                                      "running_var")]


def _vit_keys(depth: int) -> list:
    """The keys ``convert_vit`` reads."""
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    for i in range(depth):
        bp = f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                     "mlp.fc2"):
            keys += [f"{bp}.{name}.weight", f"{bp}.{name}.bias"]
    return keys


def load_backbone_params(model_name: str,
                         checkpoint_path: Optional[str] = None
                         ) -> Tuple[str, Dict[str, torch.Tensor]]:
    """-> (arch, state_dict): the trunk's tensors under the port's names,
    f32, exactly the entries the JAX package's ``convert_resnext50`` or
    ``convert_vit`` reads (a classifier head, BN's ``num_batches_tracked``
    and DINO's projection head are left behind)."""
    _, _, spec = parse_backbone_name(model_name)
    arch, _ = SPEC_TO_ARCH[spec]
    sd = load_backbone_state_dict(model_name, checkpoint_path)
    keys = (_resnext50_keys(sd) if arch == "resnext50"
            else _vit_keys(_DEPTH[arch]))
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{model_name}: the checkpoint lacks {len(missing)} "
                       f"of the trunk's entries, e.g. {missing[:3]}")
    return arch, {k: torch.as_tensor(sd[k]).float() for k in keys}


def load_backbone(model, model_name: str,
                  checkpoint_path: Optional[str] = None) -> str:
    """Copy a local backbone checkpoint into ``model``'s trunk (a CVCL, or
    its ``vision_encoder.model``), in place; returns the arch. The trunk's
    own head (``fc`` or ``head``) and an int8 plan's amax buffers keep
    their values; every other entry of the trunk must be in the file. The
    ResNeXt's folded kernel weights follow on the next forward (their
    cache keys on the tensors' versions)."""
    arch, sd = load_backbone_params(model_name, checkpoint_path)
    trunk = getattr(getattr(model, "vision_encoder", None), "model", model)
    own = trunk.state_dict()
    kept = [k for k in own if k not in sd]
    stray = [k for k in kept if not k.startswith(("fc.", "head."))
             and not k.endswith("_amax")]
    if stray or len(sd) + len(kept) != len(own):
        raise KeyError(f"{model_name} ({arch}) does not fit the trunk: "
                       f"{stray[:3] or sorted(set(sd) - set(own))[:3]}")
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(v)
    return arch
