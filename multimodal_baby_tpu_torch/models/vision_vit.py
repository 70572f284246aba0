"""DINO ViT-B/14 trunk (counterpart of
``multimodal_baby_tpu/models/vision_vit.py``): pre-norm blocks, qkv bias,
GELU MLP of ratio 4, LayerNorm eps 1e-6, a CLS token and learned absolute
positional embeddings, bicubically resized for off-grid inputs. Its
blocks (``ViTBlock``, ``per_weight_state``) also make CLIP's towers
(``models/clip.py``): ViT-L/14's 24 blocks of 1024, frozen in the CLIP
baseline and trained when CVCL fine-tunes them.

Parameters carry the reference's names (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``norm``), so a reference state dict loads as
it is, in every kernel configuration. Images come in NHWC, as in the JAX
package.

Two paths compute each block:

- the plain path (``forward_plain``): LayerNorm, the Dense layers and
  softmax attention as plain ops in the input's dtype (the JAX package's
  XLA path). In f32 it is the parity mode, on any device;
- the kernel path, in the configuration of ``ViTKernels`` (the JAX
  package's ``MMB_FUSED_ATTN``, ``MMB_VIT_MLP``, ``MMB_VIT_BLOCK`` and
  ``MMB_VIT_GELU``, resolved once when the model is built): by default
  ``ops.attention.fused_block_attention`` (K5) then
  ``ops.vit_mlp.fused_mlp`` (K6); the whole block in one kernel (K7,
  ``ops.vit_block.fused_vit_block``); or LayerNorm 1 and the attention
  module with K8a, K8b or K8c (``ops.attention``) between the qkv and proj
  Denses. The kernels run on CUDA and their plain versions on the CPU.
  ``forward`` casts the input to the compute dtype and takes this path
  exactly when that is bf16, as the JAX package dispatches its kernels.

Two opt-in modes of a frozen trunk change the function itself, so both
paths take them (the JAX package's ``MMB_VIT_INT8`` and ``MMB_VIT_LNFOLD``,
``ViTKernels.int8`` and ``.lnfold``): the 48 block Denses through int8
products (``ops.quant.int8_dense``), and LayerNorm's gamma and beta folded
into the qkv and fc1 weights (the LayerNorms then only normalize). Either
skips K5, K6 and K7, as the JAX package does; the attention between the
Dense layers is K8b, K8a, or (LN-fold without int8) K8c on the folded qkv
weight, as ``attn`` says. The parameters do not change.

The GELU form is part of the function: both paths use it. The JAX package
pads the 257 tokens to 272 for the TPU's sublane tile and masks the pad
keys; the port runs at 257 tokens, which gives the same real-token
result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.ops.attention import (
    fused_attention, fused_attention_pairs, fused_block_attention,
    fused_qkv_attention_pairs, should_fuse_attention,
    should_fuse_attention_pairs, should_fuse_block_attention,
    should_fuse_qkv_attention_pairs)
from multimodal_baby_tpu_torch.ops.quant import (
    dense_weight_codes, int8_dense)
from multimodal_baby_tpu_torch.ops.vit_block import (
    fused_vit_block, should_fuse_vit_block)
from multimodal_baby_tpu_torch.ops.vit_common import (
    GELU_MODES, gelu, layer_norm)
from multimodal_baby_tpu_torch.ops.vit_mlp import fused_mlp, should_fuse_mlp

LN_EPS = 1e-6

# the JAX package's spellings (MMB_FUSED_ATTN, MMB_VIT_MLP) -> the port's
ATTN_MODES = {"block": "block", "1": "1", "2": "pairs", "pairs": "pairs",
              "3": "qkv", "qkv": "qkv", "0": "off", "off": "off"}
MLP_MODES = {"fused": "fused", "": "off", "off": "off"}


@dataclasses.dataclass(frozen=True)
class ViTKernels:
    """The ViT's kernel configuration, checked when it is made.

    ``attn``: ``block`` (K5, the default), ``1`` (K8a on heads-first
    q, k, v), ``2``/``pairs`` (K8b), ``3``/``qkv`` (K8c, the qkv projection
    inside) or ``0``/``off`` (plain softmax attention); a mode whose shape
    gate fails falls through to the next, as in the JAX package.
    ``mlp``: ``fused`` (K6) or ``""``/``off``. ``whole_block``: K7 for the
    whole block (the JAX package's ``MMB_VIT_BLOCK=1``), before any other
    mode. ``gelu``: ``erf``, ``tanh`` or ``sigmoid``. Unknown values raise
    ValueError; spellings are stored in their port form (``pairs``,
    ``qkv``, ``off``).

    ``int8`` (``MMB_VIT_INT8``): the block Denses through int8 products;
    ``lnfold`` (``MMB_VIT_LNFOLD``): LayerNorm's affine folded into the
    qkv and fc1 weights. Both are for a frozen trunk only, and either turns
    off ``whole_block`` and the ``block`` and ``fused`` kernels (``attn``
    ``block`` then runs K8b); K8c runs with ``lnfold`` but not ``int8``."""

    attn: str = "block"
    mlp: str = "fused"
    whole_block: bool = False
    gelu: str = "erf"
    int8: bool = False
    lnfold: bool = False

    def __post_init__(self):
        for name, table in (("attn", ATTN_MODES), ("mlp", MLP_MODES)):
            value = getattr(self, name)
            if not isinstance(value, str) or value not in table:
                raise ValueError(f"ViTKernels.{name} must be one of "
                                 f"{sorted(table)}, got {value!r}")
            object.__setattr__(self, name, table[value])
        for name in ("whole_block", "int8", "lnfold"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"ViTKernels.{name} must be a bool, got "
                                 f"{getattr(self, name)!r}")
        if self.gelu not in GELU_MODES:
            raise ValueError(f"ViTKernels.gelu must be one of {GELU_MODES}, "
                             f"got {self.gelu!r}")


class LayerNorm(nn.Module):
    """LayerNorm with torch's names and the JAX package's arithmetic
    (f32 statistics, var = E[x^2] - mean^2, output in x's dtype); ``eps``
    is DINO's 1e-6 unless given (CLIP's is 1e-5)."""

    def __init__(self, dim: int, eps: float = LN_EPS, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _norm_only(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm's normalize without its affine (the LN-fold's; f32
    statistics, var = E[x^2] - mean^2, the result in x's dtype)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class Dense(NamedTuple):
    """A Dense's operands for one weight state: ``weight [in, out]`` and
    ``bias`` in the compute dtype; or, in int8, ``weight`` the codes ``[out,
    in]`` with their per-channel ``scale`` and an f32 ``bias``."""

    weight: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor | None = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale is not None:
            return int8_dense(x, self.weight, self.scale, self.bias, x.dtype)
        return F.linear(x, self.weight.t(), self.bias)


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A Dense in x's dtype (parameters stay f32, as in the JAX package)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _attention_probs(q, k, scale):
    """softmax(q k^T scale) of q, k [B, N, H, d] in their dtype, [B, H, N,
    N]."""
    return (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).softmax(-1)


def _softmax_attention(q, k, v, scale):
    """Plain softmax attention on [B, N, H, d] in their dtype."""
    return torch.einsum("bhqk,bkhd->bqhd", _attention_probs(q, k, scale), v)


class ViTAttention(nn.Module):
    """Multi-head self-attention: the plain path (``forward``), the
    kernel-mode dispatch of ``ViTAttention.__call__`` in the JAX package
    (``forward_kernels``) and the attention probabilities (``probs``)."""

    def __init__(self, dim: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        q, k, v = _dense(x, self.qkv).reshape(B, N, 3, H, C // H).unbind(2)
        y = _softmax_attention(q, k, v, (C // H) ** -0.5)
        return _dense(y.reshape(B, N, C), self.proj)

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """softmax(q k^T scale) of x's tokens, [B, H, N, N] in x's
        dtype (the JAX package's ``return_attention``)."""
        B, N, C = x.shape
        H = self.num_heads
        q, k, _ = _dense(x, self.qkv).reshape(B, N, 3, H, C // H).unbind(2)
        return _attention_probs(q, k, (C // H) ** -0.5)

    def forward_kernels(self, x: torch.Tensor, qkv_dense: Dense,
                        proj: Dense, mode: str) -> torch.Tensor:
        """Attention of the LayerNormed x in attention mode ``mode``
        between the ``qkv_dense`` and ``proj`` Denses: K8c on (x, wqkv,
        bqkv) of a float qkv Dense; or the qkv Dense, then K8b on its column
        slices, K8a on heads-first views, or plain softmax attention (mode
        ``off``); then the proj Dense. Each kernel needs its mode and its
        shape gate."""
        B, N, C = x.shape
        H = self.num_heads
        d = C // H
        scale = d ** -0.5
        if (mode == "qkv" and qkv_dense.scale is None
                and should_fuse_qkv_attention_pairs(N, H, d)):
            y = fused_qkv_attention_pairs(x, qkv_dense.weight, qkv_dense.bias,
                                          H, scale)
            return proj(y)
        qkv = qkv_dense(x)
        if (mode in ("pairs", "qkv", "block")
                and should_fuse_attention_pairs(N, H, d)):
            y = fused_attention_pairs(qkv[..., :C], qkv[..., C:2 * C],
                                      qkv[..., 2 * C:], H, scale)
            return proj(y)
        q, k, v = qkv.reshape(B, N, 3, H, d).unbind(2)       # [B, N, H, d]
        if mode == "1" and should_fuse_attention(N, d):
            def heads_first(t):
                return t.permute(0, 2, 1, 3).reshape(B * H, N, d)

            y = fused_attention(heads_first(q), heads_first(k),
                                heads_first(v), scale)
            y = y.reshape(B, H, N, d).permute(0, 2, 1, 3)
        else:
            y = _softmax_attention(q, k, v, scale)
        return proj(y.reshape(B, N, C))


class ViTBlock(nn.Module):
    """A pre-norm block. ``hidden``: the MLP's width (``dim * mlp_ratio``
    when not given); ``eps``: both LayerNorms' (DINO's 1e-6 by default,
    CLIP's 1e-5), on the plain path and in the kernels alike."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, *,
                 hidden: int | None = None, eps: float = LN_EPS,
                 device=None):
        super().__init__()
        hidden = int(dim * mlp_ratio) if hidden is None else hidden
        self.eps = eps
        self.norm1 = LayerNorm(dim, eps, device=device)
        self.attn = ViTAttention(dim, num_heads, device=device)
        self.norm2 = LayerNorm(dim, eps, device=device)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, hidden, device=device)
        self.mlp.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor, gelu_mode: str = "erf"
                ) -> torch.Tensor:
        """The plain path."""
        return self._mlp(x + self.attn(self.norm1(x)), gelu_mode)

    def _mlp(self, x: torch.Tensor, gelu_mode: str) -> torch.Tensor:
        """The plain MLP half."""
        h = gelu(_dense(self.norm2(x), self.mlp.fc1), gelu_mode)
        return x + _dense(h, self.mlp.fc2)

    def kernel_weights(self, dtype: torch.dtype) -> List[torch.Tensor]:
        """The two kernels' operands in ``dtype``: LayerNorm scale and bias,
        then the Dense weights as ``[in, out]`` (contiguous) and biases,
        for K5 (norm1, qkv, proj) and K6 (norm2, fc1, fc2)."""
        def t(w):
            return w.t().to(dtype).contiguous()

        a, m = self.attn, self.mlp
        return [p.to(dtype) for p in (
            self.norm1.weight, self.norm1.bias, t(a.qkv.weight), a.qkv.bias,
            t(a.proj.weight), a.proj.bias, self.norm2.weight, self.norm2.bias,
            t(m.fc1.weight), m.fc1.bias, t(m.fc2.weight), m.fc2.bias)]

    def dense_operands(self, dtype: torch.dtype, int8: bool, lnfold: bool
                       ) -> Dict[str, Dense]:
        """The four Denses' operands of the int8 and LN-fold modes
        (``ViTKernels.int8``, ``.lnfold``), for a frozen trunk: with
        ``lnfold``, norm1's and norm2's gamma and beta folded into qkv and
        fc1 in f32 (``gamma * W`` and ``W beta + b``, the JAX package's
        ``QuantizableDense(ln_scale=...)``); then each weight quantized
        (``int8``) or cast to ``dtype``."""
        def fold(layer, norm):
            w, b = layer.weight.float(), layer.bias.float()
            if not lnfold or norm is None:
                return w, b
            return w * norm.weight.float(), b + w @ norm.bias.float()

        def operands(w, b):
            if int8:
                codes, scale = dense_weight_codes(w)
                return Dense(codes, b, scale)
            return Dense(w.t().to(dtype).contiguous(), b.to(dtype))

        a, m = self.attn, self.mlp
        return {name: operands(*fold(layer, norm)) for name, layer, norm
                in (("qkv", a.qkv, self.norm1), ("proj", a.proj, None),
                    ("fc1", m.fc1, self.norm2), ("fc2", m.fc2, None))}

    def forward_modes(self, x: torch.Tensor, d: Dict[str, Dense],
                      kernels: ViTKernels, attn: str) -> torch.Tensor:
        """The block in the int8 and LN-fold modes on ``dense_operands``
        (the JAX package's ``ViTBlock`` with ``int8`` or ``lnfold``): the
        LayerNorms (only their normalize with ``lnfold``), the attention of
        mode ``attn`` between the qkv and proj Denses (``off`` on the plain
        path), then fc1, the GELU and fc2."""
        def norm_only(x):
            return _norm_only(x, self.eps)

        norm1, norm2 = ((norm_only, norm_only) if kernels.lnfold
                        else (self.norm1, self.norm2))
        x = x + self.attn.forward_kernels(norm1(x), d["qkv"], d["proj"],
                                          attn)
        return x + d["fc2"](gelu(d["fc1"](norm2(x)), kernels.gelu))

    def forward_kernels(self, x: torch.Tensor, w: List[torch.Tensor],
                        kernels: ViTKernels) -> torch.Tensor:
        """The kernel path on ``kernel_weights(x.dtype)`` in the
        configuration ``kernels``, in the order of the JAX package's
        ``ViTBlock.__call__``: K7 for the whole block; else K5, or LayerNorm
        1 and the attention module's mode; then K6, or LayerNorm 2, fc1,
        the GELU and fc2. Each kernel needs its mode and its shape gate."""
        B, N, C = x.shape
        H = self.attn.num_heads
        d = C // H
        hidden = self.mlp.fc1.out_features
        scale = d ** -0.5
        if kernels.whole_block and should_fuse_vit_block(N, H, d, hidden):
            return fused_vit_block(x, *w, H, scale, None, self.eps,
                                   kernels.gelu)
        if kernels.attn == "block" and should_fuse_block_attention(N, H, d):
            x = fused_block_attention(x, *w[:6], H, scale, None, self.eps)
        else:
            x = x + self.attn.forward_kernels(
                self.norm1(x), Dense(w[2], w[3]), Dense(w[4], w[5]),
                kernels.attn)
        if kernels.mlp == "fused" and should_fuse_mlp(N, C, hidden):
            return fused_mlp(x, *w[6:], self.eps, kernels.gelu)
        return self._mlp(x, kernels.gelu)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 on |x| (jax.image's 'bicubic')."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """[in, out] f32 weights of ``jax.image.resize(method="bicubic")`` along
    one axis: half-pixel centres, Keys a = -0.5, the kernel widened by
    in/out when downscaling (antialias), each column normalised."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) \
        * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)
            [:, None]).abs() / kernel_scale
    w = _keys_cubic(dist)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


class VisionTransformerDino(nn.Module):
    """``forward(x)`` with x ``[B, H, W, 3]`` returns the CLS feature after
    the final LayerNorm, ``[B, E]`` f32.

    ``dtype``: compute dtype (None = f32); parameters stay f32.
    ``frozen``: the trunk is not trained; it then runs without autograd and
    casts the kernels' weights once per weight state.
    ``vit_kernels``: the kernel configuration (None = ``ViTKernels()``,
    K5 + K6 with the erf GELU); it may be reassigned on a live model,
    through a setter that takes only a ``ViTKernels`` and refuses the int8
    and LN-fold modes on a trunk that is not frozen.
    ``generator``: a CPU generator for the seeded init
    (``reset_parameters``)."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 base_img_size: int = 224, dtype: torch.dtype | None = None,
                 frozen: bool = True, *, device=None,
                 generator: torch.Generator | None = None,
                 vit_kernels: ViTKernels | None = None):
        super().__init__()
        self.frozen = frozen
        self.vit_kernels = vit_kernels
        self.patch_size = patch_size
        self.dtype = dtype or torch.float32
        n = (base_img_size // patch_size) ** 2
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size,
                                          patch_size, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim,
                                                  device=device))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, device=device)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, device=device)
        self._operands: Dict[tuple, tuple] = {}
        self.reset_parameters(generator)

    @property
    def vit_kernels(self) -> ViTKernels:
        return self._vit_kernels

    @vit_kernels.setter
    def vit_kernels(self, value: ViTKernels | None) -> None:
        if value is None:
            value = ViTKernels()
        if not isinstance(value, ViTKernels):
            raise TypeError(f"vit_kernels must be a ViTKernels, got "
                            f"{value!r}")
        for mode, knob in (("int8", "MMB_VIT_INT8"),
                           ("lnfold", "MMB_VIT_LNFOLD")):
            if getattr(value, mode) and not self.frozen:
                raise ValueError(
                    f"ViTKernels({mode}=True) (the JAX package's {knob}=1) "
                    f"needs a frozen ViT trunk (finetune_cnn=False): the "
                    f"int8 products have no gradient and the LN fold stops "
                    f"it")
        self._vit_kernels = value

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init: Dense weights and the cls and pos tokens normal with
        std 0.02 truncated at two std (the JAX package's
        ``truncated_normal(0.02, -2, 2)``), Dense biases 0, LayerNorm 1 and
        0; the patch conv U(-k, k), k = 1 / sqrt(fan_in)."""
        def trunc_normal(p):
            v = torch.randn(p.shape, generator=generator)
            while (bad := v.abs() > 2.0).any():
                v[bad] = torch.randn(int(bad.sum()), generator=generator)
            p.copy_(v * 0.02)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal(m.weight)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        proj = self.patch_embed.proj
        k = 1.0 / math.sqrt(proj.weight[0].numel())
        for p in (proj.weight, proj.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * k) - k)
        trunc_normal(self.cls_token)
        trunc_normal(self.pos_embed)

    def interpolate_pos_encoding(self, h: int, w: int) -> torch.Tensor:
        """The pos embedding for an h x w patch grid ([1, 1 + h*w, E]):
        the stored one on its own grid, else its patch part resized as
        ``jax.image.resize(method="bicubic")`` does."""
        n = self.pos_embed.shape[1] - 1
        if h * w == n and h == w:
            return self.pos_embed
        side = int(math.sqrt(n))
        grid = self.pos_embed[0, 1:].reshape(side, side, -1)
        wh = resize_weights(side, h).to(grid.device)
        ww = resize_weights(side, w).to(grid.device)
        grid = torch.einsum("ijd,iy,jx->yxd", grid, wh, ww)
        return torch.cat([self.pos_embed[:, :1], grid.reshape(1, h * w, -1)],
                         dim=1)

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] NHWC -> tokens [B, 1 + patches, E] in x's
        dtype (the sum with the f32 tokens is taken in f32)."""
        proj = self.patch_embed.proj
        dt = x.dtype
        # NCHW view of channels-last data: the conv runs NHWC
        patches = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.to(dt),
                           proj.bias.to(dt), stride=self.patch_size)
        B, E, h, w = patches.shape
        patches = patches.flatten(2).transpose(1, 2)      # [B, h*w, E]
        tokens = torch.cat([self.cls_token.expand(B, 1, E),
                            patches.float()], dim=1)
        return (tokens + self.interpolate_pos_encoding(h, w)).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return self._run(x, kernels=self.dtype == torch.bfloat16)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Every block on the plain path, in x's dtype (the int8 and LN-fold
        modes, where set, are part of it: the JAX package's XLA path)."""
        return self._run(x, kernels=False)

    def _grad_mode(self):
        return torch.set_grad_enabled(torch.is_grad_enabled()
                                      and not self.frozen)

    def _blocks(self, tokens: torch.Tensor, kernels: bool,
                depth: int | None = None) -> Iterator[torch.Tensor]:
        """The tokens after each of the first ``depth`` blocks (all by
        default), on the kernel path of ``vit_kernels`` or the plain
        path, each in the int8 and LN-fold modes where they are set."""
        k = self.vit_kernels
        if k.int8 or k.lnfold:
            ops = self.dense_operands(tokens.dtype)
            for blk, d in zip(self.blocks[:depth], ops):
                tokens = blk.forward_modes(tokens, d, k,
                                           k.attn if kernels else "off")
                yield tokens
            return
        weights = self.kernel_weights(tokens.dtype) if kernels else None
        for i, blk in enumerate(self.blocks[:depth]):
            tokens = (blk.forward_kernels(tokens, weights[i], k) if kernels
                      else blk(tokens, k.gelu))
            yield tokens

    def _run(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        with self._grad_mode():
            tokens = self.prepare_tokens(x)
            for tokens in self._blocks(tokens, kernels):
                pass
            # LayerNorm is per token: normalise only the CLS row
            return self.norm(tokens[:, :1])[:, 0].float()

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's attention probabilities ``[B, H, N, N]``: every
        block before it as ``forward`` runs them, then the plain attention
        of the last block's LayerNormed input."""
        x = x.to(self.dtype)
        with self._grad_mode():
            tokens = self.prepare_tokens(x)
            for tokens in self._blocks(tokens, self.dtype == torch.bfloat16,
                                       len(self.blocks) - 1):
                pass
            last = self.blocks[-1]
            return last.attn.probs(last.norm1(tokens))

    def get_intermediate_layers(self, x: torch.Tensor, n: int = 1
                                ) -> List[torch.Tensor]:
        """The final-LayerNormed tokens ``[B, N, E]`` after each of the
        last ``n`` blocks, the blocks run as ``forward`` runs them."""
        x = x.to(self.dtype)
        depth = len(self.blocks)
        with self._grad_mode():
            return [self.norm(tokens) for i, tokens in enumerate(
                self._blocks(self.prepare_tokens(x),
                             self.dtype == torch.bfloat16))
                if depth - i <= n]

    def kernel_weights(self, dtype: torch.dtype
                       ) -> List[List[torch.Tensor]]:
        """Every block's kernel operands in ``dtype``
        (``ViTBlock.kernel_weights``), through ``_per_weight_state``."""
        return self._per_weight_state(
            ("kernels", dtype), lambda b: b.kernel_weights(dtype))

    def dense_operands(self, dtype: torch.dtype) -> List[Dict[str, Dense]]:
        """Every block's Dense operands in the int8 and LN-fold modes of
        ``vit_kernels`` (``ViTBlock.dense_operands``): the folds and the
        weight codes, through ``_per_weight_state``."""
        k = self.vit_kernels
        return self._per_weight_state(
            ("modes", dtype, k.int8, k.lnfold),
            lambda b: b.dense_operands(dtype, k.int8, k.lnfold))

    def _per_weight_state(self, what: tuple, make) -> list:
        """``make(block)`` for every block; a frozen trunk keeps it
        (``per_weight_state``)."""
        if not self.frozen:
            return [make(b) for b in self.blocks]
        return per_weight_state(self._operands, self.blocks, what, make)


def per_weight_state(cache: dict, blocks: nn.ModuleList, what: tuple,
                     make) -> list:
    """``make(block)`` for every block of a frozen trunk, computed once per
    weight state and kept in ``cache`` under ``what`` (the dtype and the
    modes, so a switch between configurations computes nothing anew): its
    key holds each parameter's storage and version counter, so an in-place
    update (a loaded state dict) computes it anew."""
    key = tuple((p.data_ptr(), p._version) for p in blocks.parameters())
    cached = cache.get(what)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = cache[what] = (key, [make(b) for b in blocks])
    return cached[1]


def vit_base(patch_size: int = 14, dtype: torch.dtype | None = None,
             frozen: bool = True, *, device=None,
             generator: torch.Generator | None = None,
             vit_kernels: ViTKernels | None = None) -> VisionTransformerDino:
    return VisionTransformerDino(
        patch_size=patch_size, embed_dim=768, depth=12, num_heads=12,
        dtype=dtype, frozen=frozen, device=device, generator=generator,
        vit_kernels=vit_kernels)
