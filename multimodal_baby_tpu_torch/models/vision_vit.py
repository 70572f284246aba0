"""DINO ViT-B/14 trunk (counterpart of
``multimodal_baby_tpu/models/vision_vit.py``): pre-norm blocks, qkv bias,
erf-GELU MLP of ratio 4, LayerNorm eps 1e-6, a CLS token and learned
absolute positional embeddings, bicubically resized for off-grid inputs.

Parameters carry the reference's names (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``norm``), so a reference state dict loads as
it is. Images come in NHWC, as in the JAX package.

Two paths compute each block:

- the plain path (``forward_plain``): LayerNorm, the Dense layers and
  softmax attention as plain ops in the input's dtype (the JAX package's
  XLA path). In f32 it is the parity mode, on any device;
- the kernel path: ``ops.attention.fused_block_attention`` (K5) then
  ``ops.vit_mlp.fused_mlp`` (K6), the hand-written kernels on CUDA and
  their plain versions on the CPU. ``forward`` casts the input to the
  compute dtype and takes this path exactly when that is bf16, as the JAX
  package dispatches both kernels by default.

The JAX package pads the 257 tokens to 272 for the TPU's sublane tile and
masks the pad keys; the port runs at 257 tokens, which gives the same
real-token result. Not ported: ``get_last_selfattention``,
``get_intermediate_layers``, the int8 Denses and the LN fold.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.ops.attention import fused_block_attention
from multimodal_baby_tpu_torch.ops.vit_common import layer_norm
from multimodal_baby_tpu_torch.ops.vit_mlp import fused_mlp

LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """LayerNorm with torch's names and the JAX package's arithmetic
    (f32 statistics, var = E[x^2] - mean^2, output in x's dtype)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, LN_EPS)


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A Dense in x's dtype (parameters stay f32, as in the JAX package)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class ViTAttention(nn.Module):
    """Multi-head self-attention, plain path only."""

    def __init__(self, dim: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        q, k, v = _dense(x, self.qkv).reshape(B, N, 3, H, C // H).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * (C // H) ** -0.5
        y = torch.einsum("bhqk,bkhd->bqhd", attn.softmax(-1), v)
        return _dense(y.reshape(B, N, C), self.proj)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, *,
                 device=None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = ViTAttention(dim, num_heads, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, hidden, device=device)
        self.mlp.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The plain path."""
        x = x + self.attn(self.norm1(x))
        h = F.gelu(_dense(self.norm2(x), self.mlp.fc1))
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

    def forward_kernels(self, x: torch.Tensor, w: List[torch.Tensor]
                        ) -> torch.Tensor:
        """The kernel path on ``kernel_weights(x.dtype)``."""
        H = self.attn.num_heads
        x = fused_block_attention(x, *w[:6], H, (x.shape[-1] // H) ** -0.5,
                                  None, LN_EPS)
        return fused_mlp(x, *w[6:], LN_EPS)


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
    ``generator``: a CPU generator for the seeded init
    (``reset_parameters``)."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 base_img_size: int = 224, dtype: torch.dtype | None = None,
                 frozen: bool = True, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype or torch.float32
        self.frozen = frozen
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
        self._kernel_key: tuple | None = None
        self._kernel_weights: List[List[torch.Tensor]] = []
        self.reset_parameters(generator)

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
        """Every block on the plain path, in x's dtype."""
        return self._run(x, kernels=False)

    def _run(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.frozen):
            tokens = self.prepare_tokens(x)
            weights = self.kernel_weights(x.dtype) if kernels else None
            for i, blk in enumerate(self.blocks):
                tokens = (blk.forward_kernels(tokens, weights[i]) if kernels
                          else blk(tokens))
            # LayerNorm is per token: normalise only the CLS row
            return self.norm(tokens[:, :1])[:, 0].float()

    def kernel_weights(self, dtype: torch.dtype
                       ) -> List[List[torch.Tensor]]:
        """Every block's kernel operands in ``dtype``. A frozen trunk casts
        them once per weight state: the cache key holds each parameter's
        storage and version counter, so an in-place update (a loaded state
        dict) recasts."""
        if not self.frozen:
            return [b.kernel_weights(dtype) for b in self.blocks]
        params = list(self.blocks.parameters())
        key = (dtype, *((p.data_ptr(), p._version) for p in params))
        if key != self._kernel_key:
            with torch.no_grad():
                self._kernel_weights = [b.kernel_weights(dtype)
                                        for b in self.blocks]
            self._kernel_key = key
        return self._kernel_weights


def vit_base(patch_size: int = 14, dtype: torch.dtype | None = None,
             frozen: bool = True, *, device=None,
             generator: torch.Generator | None = None
             ) -> VisionTransformerDino:
    return VisionTransformerDino(
        patch_size=patch_size, embed_dim=768, depth=12, num_heads=12,
        dtype=dtype, frozen=frozen, device=device, generator=generator)
