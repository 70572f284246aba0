"""CLIP's two towers (the model that the JAX package's CLIP baseline runs
through Hugging Face ``transformers.CLIPModel``), built from a model
directory's ``config.json`` and weights by the port itself:

    model = load_clip("openai/clip-vit-large-patch14")   # on the card
    image = model.get_image_features(pixel_values)       # [B, P] f32
    text = model.get_text_features(input_ids, attention_mask)

- The vision tower: the patch convolution (no bias), the class and
  position embeddings, ``pre_layrnorm``, pre-norm blocks
  (``models/vision_vit.py::ViTBlock``, LayerNorm eps from the config),
  ``post_layernorm`` on the class token, then ``visual_projection``. In
  bf16 its blocks run the kernel path of the DINO ViT (``ViTBlock.
  forward_kernels``): K5 and K6 by default, the JAX package's shape gates
  deciding, in the kernel configuration ``kernels`` with the GELU form the
  model's ``hidden_act`` names (``quick_gelu``: ``h * sigmoid(1.702 h)``,
  the kernels' "sigmoid" form). In f32 they run the plain path.
- The text tower: token and position embeddings, causal pre-norm blocks
  in torch's own ops (no Pallas kernel of the JAX package computes them),
  ``final_layer_norm``, the state at the end-of-text token (where the
  config's ``eos_token_id`` is 2, the old rule: the largest id of the row;
  else the first ``eos_token_id``), then ``text_projection``. It runs in
  f32, as the JAX baseline does.

The model is built on the card unless the caller passes ``device="cpu"``;
the vision tower computes in bf16 on the card and in f32 elsewhere unless
``dtype`` says otherwise. ``state_dict_from_hf`` maps a ``CLIPModel`` state
dict (numpy arrays, as ``api/hf_dir.py`` reads it) onto these towers,
q, k and v concatenated into each block's qkv Dense in K5's order.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.api.hf_dir import (
    read_config, read_state_dict, resolve_model_dir)
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.layers import resolve_device
from multimodal_baby_tpu_torch.models.vision_vit import (
    LayerNorm, ViTBlock, ViTKernels, per_weight_state)
from multimodal_baby_tpu_torch.ops.vit_common import gelu

# transformers' activation names -> the port's GELU forms
HIDDEN_ACTS = {"quick_gelu": "sigmoid", "gelu": "erf", "gelu_new": "tanh",
               "gelu_pytorch_tanh": "tanh"}


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """One tower's shape, with ``CLIPTextConfig``'s and
    ``CLIPVisionConfig``'s defaults (``vision_config`` fills the vision
    fields, ``text_config`` the text ones)."""

    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # vision
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    # text
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    eos_token_id: int = 49407

    @property
    def gelu(self) -> str:
        if self.hidden_act not in HIDDEN_ACTS:
            raise ValueError(f"CLIP: hidden_act {self.hidden_act!r} is not "
                             f"one of {sorted(HIDDEN_ACTS)}")
        return HIDDEN_ACTS[self.hidden_act]


_TEXT_DEFAULTS = dict(hidden_size=512, intermediate_size=2048,
                      num_attention_heads=8)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                        num_attention_heads=12)


def tower_configs(config: Mapping) -> tuple:
    """(text, vision, projection_dim) of a ``CLIPModel``'s config.json
    (its ``text_config_dict`` / ``vision_config_dict``, where an old file
    has them, over ``text_config`` / ``vision_config``)."""
    fields = {f.name for f in dataclasses.fields(TowerConfig)}

    def tower(key, defaults):
        given = {**(config.get(f"{key}_config") or {}),
                 **(config.get(f"{key}_config_dict") or {})}
        return TowerConfig(**{**defaults, **{k: v for k, v in given.items()
                                             if k in fields}})

    return (tower("text", _TEXT_DEFAULTS), tower("vision", _VISION_DEFAULTS),
            int(config.get("projection_dim", 512)))


def _block(cfg: TowerConfig, device) -> ViTBlock:
    return ViTBlock(cfg.hidden_size, cfg.num_attention_heads,
                    hidden=cfg.intermediate_size, eps=cfg.layer_norm_eps,
                    device=device)


class CLIPVisionTower(nn.Module):
    """``forward(pixel_values [B, 3, S, S])`` -> ``post_layernorm`` of the
    class token, ``[B, C]`` f32, S the config's ``image_size``."""

    def __init__(self, cfg: TowerConfig, dtype: torch.dtype,
                 kernels: ViTKernels, *, device=None):
        super().__init__()
        C = cfg.hidden_size
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.cfg, self.dtype, self.kernels = cfg, dtype, kernels
        self.patch_embedding = nn.Conv2d(
            cfg.num_channels, C, cfg.patch_size, cfg.patch_size, bias=False,
            device=device)
        self.class_embedding = nn.Parameter(torch.zeros(C, device=device))
        self.position_embedding = nn.Embedding(n + 1, C, device=device)
        self.pre_layrnorm = LayerNorm(C, cfg.layer_norm_eps, device=device)
        self.blocks = nn.ModuleList(_block(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNorm(C, cfg.layer_norm_eps, device=device)
        self._operands: Dict[tuple, tuple] = {}

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        S = self.cfg.image_size
        if tuple(pixel_values.shape[-2:]) != (S, S):
            raise ValueError(f"CLIP vision tower: images must be {S}x{S}, "
                             f"got {tuple(pixel_values.shape)}")
        dt = self.dtype
        with torch.no_grad():
            x = pixel_values.to(self.class_embedding.device, dt)
            patches = F.conv2d(x, self.patch_embedding.weight.to(dt),
                               stride=self.cfg.patch_size)
            B, C = patches.shape[:2]
            tokens = torch.cat([self.class_embedding.expand(B, 1, C),
                                patches.flatten(2).transpose(1, 2).float()],
                               dim=1) + self.position_embedding.weight
            tokens = self.pre_layrnorm(tokens).to(dt)
            if dt == torch.bfloat16:
                weights = per_weight_state(
                    self._operands, self.blocks, ("kernels", dt),
                    lambda b: b.kernel_weights(dt))
                for blk, w in zip(self.blocks, weights):
                    tokens = blk.forward_kernels(tokens, w, self.kernels)
            else:
                for blk in self.blocks:
                    tokens = blk(tokens, self.kernels.gelu)
            return self.post_layernorm(tokens[:, 0].float())


def _layer_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, norm.eps)


class CLIPTextTower(nn.Module):
    """``forward(input_ids [B, L], attention_mask [B, L] or None)`` -> the
    ``final_layer_norm`` state at each row's end-of-text token, ``[B, D]``
    f32. Its blocks hold ``ViTBlock``'s parameters and run torch's fused
    ops (``F.layer_norm``, ``scaled_dot_product_attention`` with the
    causal and padding mask), as transformers runs them: no kernel of the
    JAX package computes a causal block, and a tower of 12 blocks in
    unfused ops is bound by its launches."""

    def __init__(self, cfg: TowerConfig, *, device=None):
        super().__init__()
        D = cfg.hidden_size
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, D, device=device)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               D, device=device)
        self.blocks = nn.ModuleList(_block(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm(D, cfg.layer_norm_eps,
                                          device=device)

    def _block(self, blk: ViTBlock, x: torch.Tensor,
               allowed: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = blk.attn.num_heads
        qkv = blk.attn.qkv(_layer_norm(blk.norm1, x))
        q, k, v = qkv.view(B, L, 3, H, D // H).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
        x = x + blk.attn.proj(y.transpose(1, 2).reshape(B, L, D))
        h = gelu(blk.mlp.fc1(_layer_norm(blk.norm2, x)), self.cfg.gelu)
        return x + blk.mlp.fc2(h)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        device = self.token_embedding.weight.device
        ids = input_ids.to(device)
        B, L = ids.shape
        with torch.no_grad():
            x = self.token_embedding(ids) + self.position_embedding.weight[:L]
            # a query sees the keys up to itself that are not padding
            allowed = torch.ones(L, L, dtype=torch.bool,
                                 device=device).tril()[None, None]
            if attention_mask is not None:
                allowed = allowed & attention_mask.to(device).bool()[
                    :, None, None, :]
            for blk in self.blocks:
                x = self._block(blk, x, allowed)
            x = _layer_norm(self.final_layer_norm, x)
            if self.cfg.eos_token_id == 2:
                eos = ids.argmax(-1)
            else:
                eos = (ids == self.cfg.eos_token_id).int().argmax(-1)
            return x[torch.arange(B, device=device), eos]


class CLIPModel(nn.Module):
    """CLIP from a ``CLIPModel`` config.json (a dict). ``dtype``: the vision
    tower's compute dtype (None: bf16 on the card, f32 elsewhere).
    ``kernels``: a ``KernelConfig`` or its ``ViTKernels`` for the vision
    blocks (None: K5 + K6); its GELU form is replaced by the model's. The
    int8 and LN-fold modes are refused: they are not CLIP's function."""

    def __init__(self, config: Mapping, *, dtype: torch.dtype | None = None,
                 device="cuda",
                 kernels: Union[KernelConfig, ViTKernels, None] = None):
        super().__init__()
        device = resolve_device(device)
        text, vision, proj = tower_configs(config)
        if isinstance(kernels, KernelConfig):
            kernels = kernels.vit
        kernels = kernels or ViTKernels()
        if kernels.int8 or kernels.lnfold:
            raise ValueError("CLIP: the vision tower has no int8 or LN-fold "
                             "mode (ViTKernels.int8 / .lnfold)")
        kernels = dataclasses.replace(kernels, gelu=vision.gelu)
        if dtype is None:
            dtype = (torch.bfloat16 if device.type == "cuda"
                     else torch.float32)
        self.device, self.dtype = device, dtype
        self.vision_model = CLIPVisionTower(vision, dtype, kernels,
                                            device=device)
        self.text_model = CLIPTextTower(text, device=device)
        self.visual_projection = nn.Linear(vision.hidden_size, proj,
                                           bias=False, device=device)
        self.text_projection = nn.Linear(text.hidden_size, proj, bias=False,
                                         device=device)
        self.requires_grad_(False)

    @property
    def image_size(self) -> int:
        return self.vision_model.cfg.image_size

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values ``[B, 3, S, S]`` (CLIP-normalized) -> ``[B, P]``
        f32."""
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
        """input_ids, attention_mask ``[B, L]`` -> ``[B, P]`` f32."""
        return self.text_projection(self.text_model(input_ids,
                                                    attention_mask))


def state_dict_from_hf(hf: Mapping[str, np.ndarray], n_vision: int,
                       n_text: int) -> Dict[str, torch.Tensor]:
    """The port's ``CLIPModel`` state dict from a Hugging Face
    ``CLIPModel``'s (``n_vision`` and ``n_text`` blocks): names mapped,
    each block's q, k and v Denses concatenated (in that order, along the
    output axis) into its fused qkv. ``logit_scale`` and ``position_ids``
    are not used; any other name left over, or one missing, raises
    KeyError."""
    left = {k: v for k, v in hf.items()
            if k != "logit_scale" and not k.endswith("position_ids")}
    out = {}

    def take(name):
        if name not in left:
            raise KeyError(f"CLIP state dict: {name!r} is missing")
        return torch.from_numpy(np.array(left.pop(name), np.float32))

    def blocks(src, dst, n):
        for i in range(n):
            s, d = f"{src}.encoder.layers.{i}", f"{dst}.blocks.{i}"
            for part in ("weight", "bias"):
                out[f"{d}.attn.qkv.{part}"] = torch.cat([
                    take(f"{s}.self_attn.{x}_proj.{part}") for x in "qkv"])
                for a, b in (("norm1", "layer_norm1"),
                             ("attn.proj", "self_attn.out_proj"),
                             ("norm2", "layer_norm2"),
                             ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                    out[f"{d}.{a}.{part}"] = take(f"{s}.{b}.{part}")

    v, t = "vision_model", "text_model"
    out[f"{v}.patch_embedding.weight"] = take(
        f"{v}.embeddings.patch_embedding.weight")
    out[f"{v}.class_embedding"] = take(f"{v}.embeddings.class_embedding")
    out[f"{v}.position_embedding.weight"] = take(
        f"{v}.embeddings.position_embedding.weight")
    out[f"{t}.token_embedding.weight"] = take(
        f"{t}.embeddings.token_embedding.weight")
    out[f"{t}.position_embedding.weight"] = take(
        f"{t}.embeddings.position_embedding.weight")
    for a, b in ((v, "pre_layrnorm"), (v, "post_layernorm"),
                 (t, "final_layer_norm")):
        for part in ("weight", "bias"):
            out[f"{a}.{b}.{part}"] = take(f"{a}.{b}.{part}")
    blocks(v, v, n_vision)
    blocks(t, t, n_text)
    for name in ("visual_projection.weight", "text_projection.weight"):
        out[name] = take(name)
    if left:
        raise KeyError(f"CLIP state dict: unexpected {sorted(left)[:5]}")
    return out


def clip_from_state(config: Mapping, hf_state: Mapping[str, np.ndarray], *,
                    dtype: torch.dtype | None = None, device="cuda",
                    kernels: Union[KernelConfig, ViTKernels, None] = None
                    ) -> CLIPModel:
    """A ``CLIPModel`` of ``config`` holding a Hugging Face state dict."""
    model = CLIPModel(config, dtype=dtype, device=device, kernels=kernels)
    state = state_dict_from_hf(hf_state, len(model.vision_model.blocks),
                               len(model.text_model.blocks))
    model.load_state_dict(state, strict=True)
    return model.eval()


def load_clip(name: Union[str, Path], *, dtype: torch.dtype | None = None,
              device="cuda",
              kernels: Union[KernelConfig, ViTKernels, None] = None
              ) -> CLIPModel:
    """The CLIP model of a local directory or a cached name
    (``api/hf_dir.py::resolve_model_dir``; refused otherwise)."""
    model_dir = resolve_model_dir(name)
    return clip_from_state(read_config(model_dir), read_state_dict(model_dir),
                           dtype=dtype, device=device, kernels=kernels)
