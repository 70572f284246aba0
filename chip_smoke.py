#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main paths on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. The card's name and power limit; the build of the kernels
   (``multimodal_baby_tpu_torch/ops/csrc/*.cu``) with nvcc, and ptxas's
   registers, spills and stack of each kernel (K5's, K8a's and K8b's
   ``attention_mma``, K7's ``vit_block_kernel`` and K8c's
   ``qkv_attention_mma`` named, each in its one-pass and two-pass form,
   with their shared memory at N = 257; the ``vit_gemm`` Dense tile with
   K5's two epilogues and the probe's GELU forms; K6's ``vit_pingpong``
   tile in its three GELU forms (fc1) and with the residual (fc2), with
   its launch geometry at the ViT slice's shape and any ptxas warning
   about its wgmma; K10b's ``bottleneck_fused`` in its four group widths,
   and its band geometry at layer 2's head; the 1x1 convolutions' tile of
   K1 and the bf16 stage kernel, ``conv_gemm`` in its three epilogues and
   ``stage_tile_kernel`` in bf16 and int8 (K3a's int8 stages and the
   banded int8 stage) in its four group widths each, K2's and K3a's int8
   1x1 tile, ``conv_gemm_s8`` in its three epilogues, and K1's and K2's
   grouped 3x3 on their halo tiles, ``gconv_halo`` and ``gconv_halo_s8``,
   in their four: the phase fails if ptxas reports spills or a serialized
   wgmma there).
2. K1 (``fused_bottleneck``) against its plain PyTorch version on the
   same bf16 inputs with the same rounding points, for four small and
   odd-sized cases at B = 8 and the 8 distinct ResNeXt-50 block shapes at
   224 px and B = 128: max error relative to the largest output <= 1e-2,
   cosine >= 0.9999 (the bf16 words that differ are counted). Then the
   time of each version at B = 128 (CUDA events; the plain version
   computes in f32 with TF32 off), of the cuDNN bf16 channels-last conv
   chain on the same folded weights (the library call), and the bound of
   each launch; a forward's bound is the sum of its launches' (here and
   for K2, K3a, K3b, K10a and K11).
2b. K5 (``fused_block_attention``) and K6 (``fused_mlp``) against their
   plain versions, with the same gates: small and odd cases at B = 2
   (N = 10 with kv_valid = 7, and N = 17; C = 256, 4 heads, F = 1024),
   then the ViT-B/14 shapes at B = 128 (N = 257, C = 768, 12 heads,
   F = 3072), timed beside their plain versions, the library calls
   (LayerNorm, Linear, scaled_dot_product_attention or GELU, Linear and
   the residual, in bf16) and the bound; then K5 at C = 768 and B = 2 (a
   ragged row count, M = 514) at N = 257, 400 and 752, each with and
   without kv_valid = N - 5 (one pass, then two passes of the attention
   core); K6 in every GELU form at ragged row counts of its 128-row tiles,
   (B, N) = (2, 257), (3, 400) and (1, 752) at C = 768, F = 3072, and under
   one tile (M = 5, C = 256, F = 512); and K6's two Denses alone at the
   ViT-B shape (``mmb_vit_mlp_dense_bf16``, fc1 with the erf GELU, fc2
   with the residual), their time and TFLOP/s.
2c. K2 (``fused_bottleneck`` on int8), K3a (``fused_stage``) and K3b
   (``fused_stage_banded``) against their plain versions: small and odd
   cases at B = 32 (8x8 and 7x7 px, as tests/test_quant_trunk.py; K2 also
   at Cin = 64) and at ragged row counts (B = 2, 9 -> 5 and 7 x 7 px: K2
   and an int8 stage with a stride-2 head), then every shape the
   published plan gives them at 224 px and B = 128: K2 on the four int8
   block shapes of layers 3-4, K3a on the layer-3 tail and on layer 4 in
   int8 and in bf16, K3b on layer 1 with N = 28 rows. int8 gate: codes at
   most 1 apart and fewer than 1e-3 of them differing (the count is
   printed; 0 is expected: the tiles sum exactly and round as the plain
   version); bf16 gate as K1. Each main-path
   shape is timed beside its plain version, a library chain
   (torch._int_mm 1x1 GEMMs, the cuDNN grouped 3x3 on the bf16 codes and
   elementwise requantization for int8; cuDNN bf16 convolutions for
   bf16) and its bound (int8 at 1979 TOP/s). Each stage (K3a's and
   K3b's bf16 body on K1's 1x1 tile, K3a's int8 body on K2's) also equals
   its blocks' K1 or K2 launches bit for bit (the count of differing
   words or codes is printed; 0 is required), so every band count gives
   the same values.
3. The ResNeXt slice in the per-block plan: the flagship CVCL (ResNeXt-50
   at full width with seeded random weights and BN statistics, flat 512-d
   head, embedding text encoder, fixed T = 0.07, running BN) with
   ``trunk_int8=False`` and ``fused_plan=("blocks",) * 4``, 3 AdamW train
   steps at B = 128 on 224x224 uint8 frames with the augment on, then one
   eval step. Checks: finite losses, 16 K1 launches per forward, trunk
   parameters bit-unchanged, heads changed. The eval forward's pooled
   features and logits against the plain bf16 conv path on the same
   weights: per-row cosine >= 0.999; the cosine against the f32 conv path
   (TF32 off) is printed. Then the step time and the trunk time of both
   paths.
4. The ViT slice: the ViT flagship CVCL (DINO ViT-B/14 at full width and
   depth in bf16, seeded trunc-normal(0.02) Dense weights, LayerNorm
   scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1), the 1-layer transformer
   text encoder with a learned pos-embed), 3 AdamW train steps at B = 128
   with the augment and the text dropout on, then one eval step. Checks:
   finite losses, 12 K5 and 12 K6 launches per forward, every ViT tensor
   bit-unchanged, the head and the text encoder changed. The eval CLS
   features and logits against the plain bf16 blocks on the same
   weights: per-row cosine >= 0.999; the cosine against the f32 plain
   blocks is printed. Then the ViT forward time of both paths, the step
   time and pairs/s.
2d. K7 (``fused_vit_block``), K8a (``fused_attention``), K8b
   (``fused_attention_pairs``) and K8c (``fused_qkv_attention_pairs``)
   against their plain versions on phase 2b's cases, with 2b's gates; K6
   and K7 also in the tanh and sigmoid GELU forms; K7 against K5 then K6
   bit for bit in every form (the count of differing bf16 words is
   printed), also at 2b's ragged and two-pass cases; then K8a and K8b (on
   the column slices of a [B, N, 3C]
   tensor) at N = 257, 272, 273, 416 and 752 and K8c at the first four (B
   = 2, C = 768), each with and without kv_valid = N - 20:
   the edges of their register-resident design (one chunk of 272 keys,
   then two passes). Each ViT-B case is timed beside its plain version, its
   library call (scaled_dot_product_attention for K8a and K8b; Linear and
   scaled_dot_product_attention for K8c; 2b's LayerNorm / Linear / SDPA /
   GELU chain for K7, and K5 then K6) and its bound.
5. The published flagship (``bench.py:102-121``): phase 3's model with
   ``trunk_int8=(False, False, True, True)`` and the default plan
   ``("banded28", "blocks", "split", "full")``, calibrated once on 32
   augment-off frames, then 3 AdamW train steps and 1 eval step at
   B = 128. Checks: finite losses; per forward 4 K1, 1 K2, 2 K3a and 1
   K3b launches; trunk tensors and amax buffers bit-unchanged, heads
   changed; the eval pooled features and logits against the same plan run
   through the plain versions on the card: per-row cosine >= 0.999; the
   pooled features against the f32 conv path: per-row cosine > 0.99 (the
   JAX package's gate, tests/test_quant_trunk.py:188-220). Then the trunk
   forward time of the int8 plan, the bf16 per-block K1 path and the
   plain bf16 conv path, the step time and pairs/s.
6. The ViT slice of phase 4 (the same model, switched through the trunk's
   ``vit_kernels``) in each further kernel configuration: ``attn="1"``
   (K8a), ``"pairs"`` (K8b), ``"qkv"`` (K8c), ``whole_block=True`` (K7)
   and ``gelu="tanh"`` (K5, K6): 3 AdamW train steps and 1 eval step each
   at B = 128. Checks: finite losses; per forward 12 launches of the
   configuration's kernels (12 K6 beside each K8, no K5 or K6 beside K7)
   and none of the others; ViT tensors bit-unchanged, heads changed; eval
   CLS and logits against the same configuration with its kernels
   swapped for their plain versions on the card and against the plain
   bf16 blocks: per-row cosine >= 0.999 (the cosine against f32 is
   printed). Then the ViT forward and step time of each, and the step
   times of the default, attn=1, attn=pairs, attn=qkv and whole_block in
   turns (default, 1, pairs, qkv, whole_block, whole_block, qkv, pairs,
   1, default), each from phase 4's weights.
2e. K9 (``lstm_fused``) against the plain scan at (B, L, H) = (128, 25,
   512) and (128, 64, 512) with random lengths (max absolute error <= 1e-4
   on out, h_last and c_last), and K4's forward and backward
   (``fused_infonce_forward``, ``fused_infonce_backward``) against their
   plain versions at B = 128 and 1024, E = 512, on unit-norm rows at
   T = 0.07 (loss relative error <= 1e-5, LSEs absolute 1e-5, accuracies
   exact, entropies relative 1e-4, gradients atol 1e-4 and rtol 1e-3 of
   autograd through the plain loss; a repeated backward gives the same
   bits). Each timed beside its plain version (f32, TF32 off), its library
   call (cuDNN nn.LSTM over the packed embeddings, which also projects the
   inputs; torch.matmul with two F.cross_entropy calls, forward and
   autograd backward) and its f32 bound (67 TFLOP/s).
7. The LSTM text encoders on phase 5's calibrated published trunk, at
   B = 128, vocab 2350, E = H = 512, augment on. (a) The LSTM contrastive
   recipe (dropout_i 0.5, lambda_mm 1), 3 train steps and 1 eval step from
   the same weights with ``fused_lstm=None`` (the JAX length rule: no K9 at
   L = 25) and ``fused_lstm=True`` (one K9 launch per forward): eval text
   features per-row cosine >= 0.9999 and logits >= 0.999 between the two;
   ``infonce_loss`` (K4, forward and backward) on the eval features equals
   the eval step's infonce_loss to rtol 1e-5, its gradients those of
   autograd through the plain loss (atol 1e-4, rtol 1e-3); a biLSTM
   encoder's eval forward: exactly 2 K9 launches, features against the
   plain scan cosine >= 0.9999. (b) The joint recipe (lambda_mm = lambda_lm
   = 0.5, tied head with bias, ``fused_lstm=True``): 3 train steps and 1
   eval step with the LM cross-entropy and its breakdown printed, then
   beam search over 8 sequences, width 3, length 25, timed. (c) The LM
   recipe (lambda_mm 0: no image forward) at L = 64 with
   ``fused_lstm=None``: the length rule picks K9, one launch per forward.
   Each run: finite losses, trunk bit-unchanged, heads changed, step time.
2f. K10a, the int8-transport mode (``fused_bottleneck``, ``fused_stage``,
   ``fused_stage_banded`` with ``fold_block_params_t`` weights), K10b
   (``fused_bottleneck_tiles``) and K11 (``conv1x1_bn_residual_relu``)
   against their plain versions at B = 128: K10a on the blocks of the "t"
   plan (layer 2's head and tail, layer 3's head) at most 1 code apart and
   fewer than 1e-3 of the codes differing, its stages (layer 3's tail,
   layer 4, layer 1 banded at N = 28) equal to their blocks' K10a launches
   code for code, each of those in the same envelope against its plain
   version on the same input, the whole at cosine >= 0.9999 against the
   plain chain (a moved code rides the residual path on; the count is
   printed); K10b (one launch a call) at tests/test_hwbc_kernels.py:74's
   shape, the 8 ResNeXt-50 block shapes at B = 8 and layer 2's head at B
   = 128 against its plain version (phase 2's gates) and against K1
   (< 5e-5 relative, tests/test_hwbc_kernels.py:22; the share of outputs
   that differ and the largest difference in bf16 ulps printed), timed at
   layer 2's head beside K1 (before and after the turns); K11 at every conv3
   shape of a forward (phase 2's gates), its gradients at layers 1 and 4
   equal to the plain version's autograd. Each timed beside its plain
   version, its library chain (the codes in bf16 through cuDNN, then the
   output scale and rounding; cuDNN's block; bf16 matmul and the f32
   epilogue) and its bound (K10a's activations at one byte).
8. The int8-transport plans: phase 5's model with ``trunk_int8="t"`` and
   ``("t", "t", "q", "q")``, calibrated once, 3 AdamW train steps and 1
   eval step each at B = 128. Checks: finite losses; per forward "t": 5
   K10a block, 2 K10a stage and 1 K10a banded launches, "t,t,1,1": 4
   K10a block, 1 K10a banded, 1 K2 and 2 K3a, and no other; trunk
   bit-unchanged, heads changed; eval pooled features and logits against
   the same plan through the plain versions (per-row cosine >= 0.999) and
   pooled against the f32 conv path (> 0.99, tests/test_quant_trunk.py:
   295-331). Then the trunk forward and the step times of both plans and
   of phase 5's, in turns. 8c: the entry points of K10b
   (``fused_bottleneck_tiles`` on layer 2's head: one launch)
   and K11 (the conv path with ``BottleneckX(fused_epilogue=True)`` on all
   16 blocks: 16 launches per forward, pooled against the conv path
   without it at per-row cosine >= 0.999).

Prints one JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.config import (
    DataConfig, ExperimentConfig, ModelConfig, TextConfig, TrainConfig,
    VisionConfig)
from multimodal_baby_tpu_torch.core.constants import MAX_LEN_UTTERANCE
from multimodal_baby_tpu_torch.data.augment import augment_batch
from multimodal_baby_tpu_torch.models import vision_resnext, vision_vit
from multimodal_baby_tpu_torch.models.beam_search import NEG_INF
from multimodal_baby_tpu_torch.models.losses import (
    contrastive_loss_from_logits)
from multimodal_baby_tpu_torch.models.multimodal import CVCL, l2_normalize
from multimodal_baby_tpu_torch.models.text import TextEncoder
from multimodal_baby_tpu_torch.models.vision_resnext import InferenceBN
from multimodal_baby_tpu_torch.models.vision_vit import LayerNorm, ViTKernels
from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.attention import (
    MAX_TOKENS_QKV, attention_geometry, attention_pairs_reference,
    attention_reference, block_attention_reference, fused_attention,
    fused_attention_pairs, fused_block_attention, fused_qkv_attention_pairs,
    qkv_attention_pairs_reference)
from multimodal_baby_tpu_torch.ops.bottleneck import (
    block_geometry, block_geometry_s8, block_reference,
    bottleneck_reference, default_band,
    fused_bottleneck, fused_bottleneck_tiles, tiles_geometry,
    tiles_reference)
from multimodal_baby_tpu_torch.ops.conv_epilogue import (
    conv1x1_bn_residual_relu, epilogue_reference)
from multimodal_baby_tpu_torch.ops.infonce import (
    fused_infonce_backward, fused_infonce_forward,
    fused_infonce_with_metrics, infonce_backward_reference, infonce_loss,
    infonce_reference)
from multimodal_baby_tpu_torch.ops.lstm import lstm_fused, scan_reference
from multimodal_baby_tpu_torch.ops.quant import (
    bottleneck_reference_q, bottleneck_reference_t, fold_block_params_q,
    fold_block_params_t)
from multimodal_baby_tpu_torch.ops.stage import (
    fused_stage, fused_stage_banded, stage_reference)
from multimodal_baby_tpu_torch.ops.vit_block import (
    fused_vit_block, vit_block_reference)
from multimodal_baby_tpu_torch.ops.vit_common import GELU_MODES
from multimodal_baby_tpu_torch.ops.vit_mlp import (
    fused_mlp, mlp_geometry, mlp_reference)
from multimodal_baby_tpu_torch.train.step import (
    calibrate_trunk, init_train_state, make_eval_step, make_train_step)

BATCH = 128          # the slices' batch: the kernels are checked and timed at it
CHECK_BATCH = 8      # the batch of the small and odd-sized K1 checks
VOCAB = 2350
REL_TOL = 1e-2
COS_TOL = 0.9999
SLICE_COS_TOL = 0.999
TRAIN_STEPS = 3
TIMED_STEPS = 10
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores, at 700 W
PEAK_OPS_INT8 = 1979e12  # H100 SXM dense int8 tensor cores, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
Q_CHECK_BATCH = 32   # the int8 plans' batch multiple
MIXED = (False, False, True, True)  # bench.py:117

# (name, H, Cin, width, Cout, stride, downsample, blocks per forward)
BLOCKS_224 = [
    ("layer1.0", 56, 64, 128, 256, 1, True, 1),
    ("layer1.1", 56, 256, 128, 256, 1, False, 2),
    ("layer2.0", 56, 256, 256, 512, 2, True, 1),
    ("layer2.1", 28, 512, 256, 512, 1, False, 3),
    ("layer3.0", 28, 512, 512, 1024, 2, True, 1),
    ("layer3.1", 14, 1024, 512, 1024, 1, False, 5),
    ("layer4.0", 14, 1024, 1024, 2048, 2, True, 1),
    ("layer4.1", 7, 2048, 1024, 2048, 1, False, 2),
]
# correctness only: layer 4 at 64 px (4x4 -> 2x2), and odd spatial sizes
BLOCKS_EDGE = [
    ("layer4.0@64px", 4, 1024, 1024, 2048, 2, True, 0),
    ("layer4.1@64px", 2, 2048, 1024, 2048, 1, False, 0),
    ("odd 7->4 stride 2", 7, 512, 256, 512, 2, True, 0),
    ("odd 5x5 stride 1", 5, 256, 128, 256, 1, False, 0),
]
# K1's 1x1 tile (csrc/conv_gemm.cuh) in its three epilogues (the mangled
# ConvEpilogue<b2, residual>)
CONV_TILE_FORMS = {"ConvEpilogueILb0ELb0E": "conv1",
                   "ConvEpilogueILb1ELb0E": "conv3 with the downsample",
                   "ConvEpilogueILb0ELb1E": "conv3 with the residual"}
# (B, N, C, heads, F, kv_valid); the last is ViT-B/14 at the slice's batch
VIT_CASES = [(2, 10, 256, 4, 1024, 7), (2, 17, 256, 4, 1024, None),
             (BATCH, 257, 768, 12, 3072, None)]
# K5 (phase 2b) and K7 (phase 2d) also at ViT-B width with a ragged row
# count (B = 2: M = 514) and at two-pass lengths of the attention core, up
# to both kernels' cap of 752 tokens
VIT_LONG_CASES = [(2, n, 768, 12, 3072, kv) for n in (257, 400, 752)
                  for kv in (None, n - 5)]
# K6 (phase 2b) at ragged row counts of its 128-row tiles and under one
# tile: (B, N, C, F)
MLP_RAGGED_CASES = [(2, 257, 768, 3072), (3, 400, 768, 3072),
                    (1, 752, 768, 3072), (1, 5, 256, 512)]
VIT_DEPTH = 12
# the ViT kernel wrappers, by the TPU kernel each replaces
VIT_KERNELS = {"K5": fused_block_attention, "K6": fused_mlp,
               "K7": fused_vit_block, "K8a": fused_attention,
               "K8b": fused_attention_pairs, "K8c": fused_qkv_attention_pairs}
# phase 6: configuration -> (ViTKernels, launches per forward)
VIT_CONFIGS = {
    "attn=1": (ViTKernels(attn="1"), {"K8a": VIT_DEPTH, "K6": VIT_DEPTH}),
    "attn=pairs": (ViTKernels(attn="pairs"),
                   {"K8b": VIT_DEPTH, "K6": VIT_DEPTH}),
    "attn=qkv": (ViTKernels(attn="qkv"), {"K8c": VIT_DEPTH, "K6": VIT_DEPTH}),
    "whole_block": (ViTKernels(whole_block=True), {"K7": VIT_DEPTH}),
    "gelu=tanh": (ViTKernels(gelu="tanh"), {"K5": VIT_DEPTH,
                                            "K6": VIT_DEPTH}),
}
# phase 6: the configurations whose step times are taken in turns
VIT_TURNS = {"default": ViTKernels(), "attn=1": ViTKernels(attn="1"),
             "attn=pairs": ViTKernels(attn="pairs"),
             "attn=qkv": ViTKernels(attn="qkv"),
             "whole_block": ViTKernels(whole_block=True)}
# phase 2d: K8a-c at the edges of their register-resident design
# (N = 257 and 272: a row's scores in one chunk of registers; 273: the
# first N over it, two passes; K8c's cap 416, K8a's 752), with and without
# kv_valid: (B, N, C, heads, kv_valid)
K8_EDGE_CASES = [(2, n, 768, 12, kv) for n in (257, 272, 273, 416, 752)
                 for kv in (None, n - 20)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(ms, what bounds it): the larger of the two least times."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def launch_bound(total, flops, nbytes, count=1, peak=PEAK_FLOPS):
    """One launch's bound, added ``count`` times to a per-forward total: a
    forward runs its launches one after another, so its bound is the sum of
    theirs (``total["bound_ms"]``; ``total["bound_by"]`` names what bounds
    the launches that carry most of it). Returns the launch's (ms, by)."""
    ms, by = bound(flops, nbytes, peak)
    total["bound_ms"] = total.get("bound_ms", 0.0) + count * ms
    share = total.setdefault("bound_share", {"operations": 0.0, "bytes": 0.0})
    share[by] += count * ms
    total["bound_by"] = max(share, key=share.get)
    return ms, by


def cosine(a, b):
    # in f64: an f32 dot over the tens of millions of outputs of one block
    # at B = 128 is itself off in the fourth digit
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def row_cosines(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(kernel, plain, library, iters):
    """(kernel, plain, library) ms, timed plain, kernel, library, library,
    kernel, plain; each entry is the mean of its two turns."""
    p1, k1, l1 = (time_ms(plain, max(iters // 4, 2)), time_ms(kernel, iters),
                  time_ms(library, iters))
    l2, k2, p2 = (time_ms(library, iters), time_ms(kernel, iters),
                  time_ms(plain, max(iters // 4, 2)))
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2


def check(what, got, want) -> float:
    """A kernel's output against its plain version; returns the max abs
    error."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-12)
    cos = cosine(got, want)
    words = int((got != want).sum()) if got.dtype == want.dtype else -1
    log(f"  {what:34s} out {tuple(got.shape)}: max_abs_err {err:.4g} "
        f"rel {rel:.3e} cos {cos:.7f}, {words} of {got.numel()} words "
        f"differ")
    if not (math.isfinite(rel) and rel <= REL_TOL and cos >= COS_TOL):
        raise AssertionError(
            f"{what}: rel {rel:.3e} (<= {REL_TOL}) cos {cos:.7f} "
            f"(>= {COS_TOL})")
    return err


# ----------------------------------------------------------------- phase 2

def random_block(gen, H, cin, width, cout, stride, has_ds, batch):
    """bf16 post-ReLU input and folded weights of one block, on the card."""
    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) * math.sqrt(2.0 / fan_in)
                ).to("cuda", torch.bfloat16)

    def b(n):
        return (0.1 * torch.randn(n, generator=gen)).to("cuda")

    fw = {"w1": w(cin, width, fan_in=cin), "b1": b(width),
          "w2": w(3, 3, width // 32, width, fan_in=9 * width // 32),
          "b2": b(width),
          "w3": w(width, cout, fan_in=width), "b3": b(cout)}
    if has_ds:
        fw["wd"] = w(cin, cout, fan_in=cin)
        fw["bd"] = b(cout)
    x = torch.randn(batch, H, H, cin, generator=gen).clamp_min(0.0)
    return x.to("cuda", torch.bfloat16), fw


def conv_chain(fw, stride):
    """The library call for K1: cuDNN bf16 convolutions, channels-last, on
    the same folded weights (biases in bf16)."""
    cl = torch.channels_last

    def conv_w(w):  # [in, out] -> [out, in, 1, 1]
        return w.t()[:, :, None, None].contiguous(memory_format=cl)

    cw = {"w1": conv_w(fw["w1"]), "w3": conv_w(fw["w3"]),
          "w2": fw["w2"].permute(3, 2, 0, 1).contiguous(memory_format=cl)}
    if "wd" in fw:
        cw["wd"] = conv_w(fw["wd"])
    cb = {k: v.to(torch.bfloat16) for k, v in fw.items() if k[0] == "b"}

    def run(x):
        xc = x.permute(0, 3, 1, 2)           # NCHW view of NHWC data
        h = F.relu(F.conv2d(xc, cw["w1"], cb["b1"]))
        h = F.relu(F.conv2d(h, cw["w2"], cb["b2"], stride=stride, padding=1,
                            groups=32))
        y = F.conv2d(h, cw["w3"], cb["b3"])
        idn = (F.conv2d(xc, cw["wd"], cb["bd"], stride=stride)
               if "wd" in cw else xc)
        return F.relu(y + idn)

    return run


def phase_k1():
    gen = torch.Generator().manual_seed(1)
    max_abs = 0.0
    for name, H, cin, width, cout, s, ds, _ in BLOCKS_EDGE:
        x, fw = random_block(gen, H, cin, width, cout, s, ds, CHECK_BATCH)
        max_abs = max(max_abs, check(
            f"K1 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference(x, fw, stride=s)))

    # the trunk's block shapes at the slice's batch: checked, then timed
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    for name, H, cin, width, cout, s, ds, count in BLOCKS_224:
        x, fw = random_block(gen, H, cin, width, cout, s, ds, BATCH)
        max_abs = max(max_abs, check(
            f"K1 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference(x, fw, stride=s)))
        lib = conv_chain(fw, s)
        k, p, li = time_in_turns(
            lambda: fused_bottleneck(x, fw, stride=s),
            lambda: bottleneck_reference(x, fw, stride=s),
            lambda: lib(x), 20)
        Ho = (H - 1) // s + 1
        flops = 2 * BATCH * (
            H * H * cin * width
            + Ho * Ho * (9 * width // 32 * width + width * cout
                         + (cin * cout if ds else 0)))
        nbytes = (2 * BATCH * (H * H * cin + Ho * Ho * cout)
                  + sum(t.numel() * t.element_size() for t in fw.values()))
        b_ms, b_by = launch_bound(total, flops, nbytes, count)
        log(f"  K1 {name} B={BATCH}: kernel {k:.3f} ms, plain f32 {p:.3f} "
            f"ms, cuDNN bf16 {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {flops / k / 1e9:.1f} TFLOP/s")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            total[key] += count * v
        del x, fw, lib
    log(f"  K1 over the 16 blocks of one forward at B={BATCH}: kernel "
        f"{total['ms']:.3f} ms, plain f32 {total['plain_ms']:.3f} ms, cuDNN "
        f"bf16 {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} "
        f"ms summed per launch ({total['bound_by']}: "
        f"{total['bound_share']})")
    return dict(max_abs_err=max_abs, ms=total["ms"],
                plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                bound_by=total["bound_by"], library_ms=total["library_ms"])


# ---------------------------------------------------------------- phase 2b

def vit_half_inputs(gen, kind, B, N, C, F_):
    """bf16 x and the half's operands: LayerNorm scale and bias, then
    (wqkv [C, 3C], bqkv, wproj [C, C], bproj) or (w1 [C, F], b1, w2, b2)."""
    out_a, in_b = (3 * C, C) if kind == "attention" else (F_, F_)
    shapes = [((B, N, C), 1.0), ((C,), 0.1), ((C,), 0.1),
              ((C, out_a), C ** -0.5), ((out_a,), 0.1),
              ((in_b, C), in_b ** -0.5), ((C,), 0.1)]
    x, *params = [(torch.randn(*s, generator=gen) * sc).to("cuda",
                                                           torch.bfloat16)
                  for s, sc in shapes]
    params[0] = params[0] + 1.0
    return x, params


def attention_library(x, params, heads):
    """The library call for K5, in bf16: LayerNorm, Linear,
    scaled_dot_product_attention, Linear and the residual."""
    g, b, wqkv, bqkv, wproj, bproj = params
    wq, wp = wqkv.t().contiguous(), wproj.t().contiguous()
    B, N, C = x.shape

    def run():
        xn = F.layer_norm(x, (C,), g, b, 1e-6)
        q, k, v = (F.linear(xn, wq, bqkv).reshape(B, N, 3, heads, C // heads)
                   .permute(2, 0, 3, 1, 4))
        y = F.scaled_dot_product_attention(q, k, v)
        return x + F.linear(y.transpose(1, 2).reshape(B, N, C), wp, bproj)

    return run


def mlp_chain(params):
    """The library call for K6 as a function of x, in bf16: LayerNorm,
    Linear, GELU, Linear and the residual."""
    g, b, w1, b1, w2, b2 = params
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()

    def run(x):
        h = F.gelu(F.linear(F.layer_norm(x, (x.shape[-1],), g, b, 1e-6), w1t,
                            b1))
        return x + F.linear(h, w2t, b2)

    return run


def mlp_library(x, params):
    chain = mlp_chain(params)
    return lambda: chain(x)


def phase_vit_kernels():
    gen = torch.Generator().manual_seed(2)
    out = {}
    for B, N, C, heads, F_, kv in VIT_CASES:
        scale = (C // heads) ** -0.5
        xa, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
        xm, pm = vit_half_inputs(gen, "mlp", B, N, C, F_)
        runs = {
            "K5": (lambda: fused_block_attention(xa, *pa, heads, scale, kv),
                   lambda: block_attention_reference(xa, *pa, heads, scale,
                                                     kv),
                   attention_library(xa, pa, heads),
                   (2 * B * N * C * 3 * C + 2 * B * N * C * C
                    + 4 * B * N * N * C),
                   2 * (2 * B * N * C) + 2 * 4 * C * C),
            "K6": (lambda: fused_mlp(xm, *pm), lambda: mlp_reference(xm, *pm),
                   mlp_library(xm, pm), 4 * B * N * C * F_,
                   2 * (2 * B * N * C) + 2 * 2 * C * F_)}
        for name, (kernel, plain, library, flops, nbytes) in runs.items():
            what = f"{name} B={B} N={N} C={C}" + (
                f" kv_valid={kv}" if name == "K5" else f" F={F_}")
            with torch.no_grad():
                err = check(what, kernel(), plain())
            res = out.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if B != BATCH:
                continue
            with torch.no_grad():
                k, p, li = time_in_turns(kernel, plain, library, 20)
            b_ms, b_by = bound(flops, nbytes)
            log(f"  {name} B={B} N={N} C={C}: kernel {k:.3f} ms, plain "
                f"{p:.3f} ms, library bf16 {li:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by}); kernel {flops / k / 1e9:.1f} TFLOP/s")
            # per forward: one launch per block
            b_fwd, _ = bound(VIT_DEPTH * flops, VIT_DEPTH * nbytes)
            res.update(ms=VIT_DEPTH * k, plain_ms=VIT_DEPTH * p,
                       library_ms=VIT_DEPTH * li, bound_ms=b_fwd,
                       bound_by=b_by)
    with torch.no_grad():
        for B, N, C, heads, F_, kv in VIT_LONG_CASES:
            scale = (C // heads) ** -0.5
            xa, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
            err = check(f"K5 B={B} N={N} C={C} kv_valid={kv}",
                        fused_block_attention(xa, *pa, heads, scale, kv),
                        block_attention_reference(xa, *pa, heads, scale, kv))
            out["K5"]["max_abs_err"] = max(out["K5"]["max_abs_err"], err)
        for B, N, C, F_ in MLP_RAGGED_CASES:
            xm, pm = vit_half_inputs(gen, "mlp", B, N, C, F_)
            for gelu in GELU_MODES:
                err = check(f"K6 {gelu} B={B} N={N} C={C} F={F_}",
                            fused_mlp(xm, *pm, 1e-6, gelu),
                            mlp_reference(xm, *pm, 1e-6, gelu))
                out["K6"]["max_abs_err"] = max(out["K6"]["max_abs_err"], err)
        mlp_denses(gen)
    for name, res in out.items():
        log(f"  {name} over the {VIT_DEPTH} blocks of one forward at "
            f"B={BATCH}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f}"
            f" ms, library bf16 {res['library_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return out


def mlp_denses(gen):
    """K6's fc1 (bias and the erf GELU) and fc2 (the residual sum) alone on
    its ping-pong tile at the ViT-B shape of the slice, through the
    library's ``mmb_vit_mlp_dense_bf16`` (not counted as wrapper
    launches): each checked against its f32 product, then timed."""
    lib = _build.library()
    M, C, F_ = BATCH * 257, 768, 3072
    geo = mlp_geometry(
        M, C, F_, torch.cuda.get_device_properties(0).multi_processor_count)
    stream = torch.cuda.current_stream().cuda_stream
    for name, K, N, epi, d in (("fc1", C, F_, 2, geo.fc1),
                               ("fc2", F_, C, 1, geo.fc2)):
        a = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(K, N, generator=gen) * K ** -0.5).to(
            "cuda", torch.bfloat16)
        bias = (torch.randn(N, generator=gen) * 0.1).to("cuda",
                                                        torch.bfloat16)
        res = torch.randn(M, N, generator=gen).to("cuda", torch.bfloat16)
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")

        def run():
            _build.check(lib, lib.mmb_vit_mlp_dense_bf16(
                a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                res.data_ptr() if epi == 1 else 0, out.data_ptr(), M, K, N,
                epi, 0, d.grid, stream), name)

        run()
        exact = a.float() @ w.float()
        want = (F.gelu(exact + bias.float()) if epi == 2
                else res.float() + exact + bias.float())
        check(f"K6 {name} alone [{M}x{K}].[{K}x{N}]", out, want)
        ms = time_ms(run, 20)
        log(f"  K6 {name} alone: {ms:.4f} ms, "
            f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s ({d.grid} blocks, "
            f"{d.tiles} tiles)")


# ---------------------------------------------------------------- phase 2d

def sdpa_token_major(q, k, v, heads):
    """scaled_dot_product_attention on [B, N, C] views, heads (head, d)."""
    B, N, C = q.shape

    def split(t):
        return t.reshape(B, N, heads, C // heads).transpose(1, 2)

    y = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return y.transpose(1, 2).reshape(B, N, C)


def phase_vit_more_kernels():
    gen = torch.Generator().manual_seed(4)
    out = {k: {"max_abs_err": 0.0} for k in ("K7", "K8a", "K8b", "K8c")}
    for B, N, C, heads, F_, kv in VIT_CASES:
        scale = (C // heads) ** -0.5
        x, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
        _, pm = vit_half_inputs(gen, "mlp", 1, 1, C, F_)
        blk = pa + pm
        qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda",
                                                         torch.bfloat16)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

        def heads_first(t):
            return (t.reshape(B, N, heads, C // heads).transpose(1, 2)
                    .reshape(B * heads, N, C // heads))

        qh, kh, vh = map(heads_first, (q, k, v))
        tag = f"B={B} N={N} C={C}" + (f" kv_valid={kv}" if kv else "")

        def note(name, err):
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

        with torch.no_grad():
            for gelu in GELU_MODES:
                if gelu != "erf":  # 2b checks the erf form
                    check(f"K6 {gelu} {tag}", fused_mlp(x, *pm, 1e-6, gelu),
                          mlp_reference(x, *pm, 1e-6, gelu))
                k7 = fused_vit_block(x, *blk, heads, scale, kv, 1e-6, gelu)
                note("K7", check(f"K7 {gelu} {tag}", k7, vit_block_reference(
                    x, *blk, heads, scale, kv, 1e-6, gelu)))
                two = fused_mlp(fused_block_attention(x, *pa, heads, scale,
                                                      kv), *pm, 1e-6, gelu)
                n_diff = int((k7.view(torch.int16)
                              != two.view(torch.int16)).sum())
                log(f"  K7 {gelu} {tag}: {n_diff} of {k7.numel()} bf16 words "
                    f"differ from K5 then K6")
                if n_diff:
                    raise AssertionError(f"K7 {gelu} {tag}: {n_diff} words "
                                         f"differ from K5 then K6")
            note("K8a", check(f"K8a {tag}", fused_attention(qh, kh, vh, scale,
                                                            kv),
                              attention_reference(qh, kh, vh, scale, kv)))
            note("K8b", check(f"K8b {tag}",
                              fused_attention_pairs(q, k, v, heads, scale, kv),
                              attention_pairs_reference(q, k, v, heads, scale,
                                                        kv)))
            note("K8c", check(f"K8c {tag}", fused_qkv_attention_pairs(
                x, pa[2], pa[3], heads, scale, kv),
                qkv_attention_pairs_reference(x, pa[2], pa[3], heads, scale,
                                              kv)))
        if B != BATCH:
            continue
        wqkv_t = pa[2].t().contiguous()
        block_chain = (attention_library(x, pa, heads), mlp_chain(pm))
        act = 2 * B * N * C  # bytes of one [B, N, C] bf16 tensor
        attn_flops = 4 * B * N * N * C
        runs = {
            "K7": (lambda: fused_vit_block(x, *blk, heads, scale),
                   lambda: vit_block_reference(x, *blk, heads, scale),
                   lambda: block_chain[1](block_chain[0]()),
                   (2 * B * N * C * 3 * C + 2 * B * N * C * C + attn_flops
                    + 4 * B * N * C * F_),
                   2 * act + 2 * (4 * C * C + 2 * C * F_)),
            "K8a": (lambda: fused_attention(qh, kh, vh, scale),
                    lambda: attention_reference(qh, kh, vh, scale),
                    lambda: F.scaled_dot_product_attention(
                        qh[None], kh[None], vh[None])[0],
                    attn_flops, 4 * act),
            "K8b": (lambda: fused_attention_pairs(q, k, v, heads, scale),
                    lambda: attention_pairs_reference(q, k, v, heads, scale),
                    lambda: sdpa_token_major(q, k, v, heads),
                    attn_flops, 4 * act),
            "K8c": (lambda: fused_qkv_attention_pairs(x, pa[2], pa[3], heads,
                                                      scale),
                    lambda: qkv_attention_pairs_reference(x, pa[2], pa[3],
                                                          heads, scale),
                    lambda: sdpa_token_major(
                        *F.linear(x, wqkv_t, pa[3]).split(C, -1), heads),
                    2 * B * N * C * 3 * C + attn_flops,
                    2 * act + 2 * (3 * C * C + 3 * C))}
        with torch.no_grad():
            for name, (kernel, plain, library, flops, nbytes) in runs.items():
                kms, pms, lms = time_in_turns(kernel, plain, library, 20)
                b_ms, b_by = bound(flops, nbytes)
                log(f"  {name} B={B} N={N} C={C}: kernel {kms:.3f} ms, plain "
                    f"{pms:.3f} ms, library bf16 {lms:.3f} ms, bound "
                    f"{b_ms:.3f} ms ({b_by}); kernel "
                    f"{flops / kms / 1e9:.1f} TFLOP/s")
                b_fwd, _ = bound(VIT_DEPTH * flops, VIT_DEPTH * nbytes)
                out[name].update(ms=VIT_DEPTH * kms, plain_ms=VIT_DEPTH * pms,
                                 library_ms=VIT_DEPTH * lms, bound_ms=b_fwd,
                                 bound_by=b_by)
            two_ms = time_ms(lambda: fused_mlp(fused_block_attention(
                x, *pa, heads, scale), *pm), 20)
        log(f"  K7 against the port's own K5 then K6 at B={B}: "
            f"{out['K7']['ms'] / VIT_DEPTH:.3f} against {two_ms:.3f} ms per "
            f"block")
    with torch.no_grad():
        for B, N, C, heads, F_, kv in VIT_LONG_CASES:
            scale = (C // heads) ** -0.5
            x, pa = vit_half_inputs(gen, "attention", B, N, C, F_)
            _, pm = vit_half_inputs(gen, "mlp", 1, 1, C, F_)
            tag = f"B={B} N={N} C={C}" + (f" kv_valid={kv}" if kv else "")
            for gelu in GELU_MODES:
                k7 = fused_vit_block(x, *pa, *pm, heads, scale, kv, 1e-6,
                                     gelu)
                out["K7"]["max_abs_err"] = max(
                    out["K7"]["max_abs_err"],
                    check(f"K7 {gelu} {tag}", k7, vit_block_reference(
                        x, *pa, *pm, heads, scale, kv, 1e-6, gelu)))
                two = fused_mlp(fused_block_attention(x, *pa, heads, scale,
                                                      kv), *pm, 1e-6, gelu)
                n_diff = int((k7.view(torch.int16)
                              != two.view(torch.int16)).sum())
                log(f"  K7 {gelu} {tag}: {n_diff} of {k7.numel()} bf16 words "
                    f"differ from K5 then K6")
                if n_diff:
                    raise AssertionError(f"K7 {gelu} {tag}: {n_diff} words "
                                         f"differ from K5 then K6")
        for B, N, C, heads, kv in K8_EDGE_CASES:
            scale = (C // heads) ** -0.5
            tag = f"B={B} N={N} C={C}" + (f" kv_valid={kv}" if kv else "")
            qh, kh, vh = (torch.randn(B * heads, N, C // heads, generator=gen)
                          .to("cuda", torch.bfloat16) for _ in range(3))
            out["K8a"]["max_abs_err"] = max(
                out["K8a"]["max_abs_err"],
                check(f"K8a {tag}", fused_attention(qh, kh, vh, scale, kv),
                      attention_reference(qh, kh, vh, scale, kv)))
            qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda",
                                                             torch.bfloat16)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            out["K8b"]["max_abs_err"] = max(
                out["K8b"]["max_abs_err"],
                check(f"K8b {tag}",
                      fused_attention_pairs(q, k, v, heads, scale, kv),
                      attention_pairs_reference(q, k, v, heads, scale, kv)))
            if N > MAX_TOKENS_QKV:
                continue
            x, pa = vit_half_inputs(gen, "attention", B, N, C, 4 * C)
            out["K8c"]["max_abs_err"] = max(
                out["K8c"]["max_abs_err"],
                check(f"K8c {tag}", fused_qkv_attention_pairs(
                    x, pa[2], pa[3], heads, scale, kv),
                    qkv_attention_pairs_reference(x, pa[2], pa[3], heads,
                                                  scale, kv)))
    for name, res in out.items():
        log(f"  {name} over the {VIT_DEPTH} blocks of one forward at "
            f"B={BATCH}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f}"
            f" ms, library bf16 {res['library_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return out


# ---------------------------------------------------------------- phase 2e

PEAK_FLOPS_F32 = 67e12  # H100 SXM f32 outside the tensor cores, at 700 W
LSTM_H = 512            # CVCL's hidden width (= the embedding width)
LM_LEN = 64             # the JAX package's length rule: K9 from 64 steps
INFONCE_E = 512
INFONCE_BATCHES = (BATCH, 1024)  # the slice's batch; MAX_FUSED_BATCH


def lstm_case(gen, B, L, H):
    """K9's inputs at (B, L, H) with the lengths make_batch gives (1 to L),
    the time-major input projection of N(0, 1) embeddings, and cuDNN's
    nn.LSTM with the same weights over the packed embeddings (the library
    call, which also does the input projection)."""
    k = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * k

    lens = torch.randint(1, L + 1, (B,), generator=gen)
    lens[0] = L
    w_ih, w_hh, b_ih, b_hh = u(4 * H, H), u(4 * H, H), u(4 * H), u(4 * H)
    emb = torch.randn(B, L, H, generator=gen)
    h0, c0 = 0.1 * torch.randn(B, H, generator=gen), torch.zeros(B, H)
    lib = torch.nn.LSTM(H, H, batch_first=True)
    with torch.no_grad():
        for name, w in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                        ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(lib, name).copy_(w)
    lib = lib.cuda()
    emb, h0, c0 = emb.cuda(), h0.cuda(), c0.cuda()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        emb, lens, batch_first=True, enforce_sorted=False)
    x_proj = (emb @ w_ih.cuda().T + (b_ih + b_hh).cuda()).transpose(0, 1)
    mask = (torch.arange(L)[:, None] < lens[None, :]).float().cuda()
    args = (x_proj.contiguous(), mask, w_hh.T.contiguous().cuda(), h0, c0)
    return args, (lambda: lib(packed, (h0[None], c0[None]))), lens


def lstm_cost(L, B, H, lens):
    """(flops, bytes) K9 needs: the h W_hh products of the valid steps (the
    gates' few operations per unit are left out), each input read once and
    each output written once, in f32."""
    flops = 2 * int(lens.sum()) * H * 4 * H
    nbytes = 4 * (L * B * 4 * H + L * B + H * 4 * H + 2 * B * H
                  + L * B * H + 2 * B * H)
    return flops, nbytes


def phase_lstm_kernel():
    gen = torch.Generator().manual_seed(7)
    res = {"max_abs_err": 0.0}
    for L in (MAX_LEN_UTTERANCE, LM_LEN):
        args, library, lens = lstm_case(gen, BATCH, L, LSTM_H)
        with torch.no_grad():
            got = lstm_fused(*args)
            want = scan_reference(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("out", "h_last", "c_last"), got, want):
                err = float((g - w).abs().max())
                log(f"  K9 B={BATCH} L={L} H={LSTM_H} {name} "
                    f"{tuple(g.shape)}: max_abs_err {err:.3g}")
                if not err <= 1e-4:
                    raise AssertionError(f"K9 L={L} {name}: max abs err "
                                         f"{err:.3g} > 1e-4")
                res["max_abs_err"] = max(res["max_abs_err"], err)
            out_lib, _ = library()
            unpacked, _ = torch.nn.utils.rnn.pad_packed_sequence(
                out_lib, batch_first=True, total_length=L)
            lib_err = float((unpacked.transpose(0, 1) - want[0]).abs().max())
            log(f"  cuDNN nn.LSTM against the plain scan: max abs err "
                f"{lib_err:.3g}")
            kms, pms, lms = time_in_turns(lambda: lstm_fused(*args),
                                          lambda: scan_reference(*args),
                                          library, 20)
        flops, nbytes = lstm_cost(L, BATCH, LSTM_H, lens)
        b_ms, b_by = bound(flops, nbytes, PEAK_FLOPS_F32)
        log(f"  K9 B={BATCH} L={L} H={LSTM_H} ({int(lens.sum())} valid "
            f"steps): kernel {kms:.3f} ms, plain scan {pms:.3f} ms, cuDNN "
            f"nn.LSTM {lms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); kernel "
            f"{flops / kms / 1e9:.2f} TFLOP/s")
        if L == MAX_LEN_UTTERANCE:  # the slice's window
            res.update(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                       bound_by=b_by)
    return res


def infonce_library(img, txt, nlt):
    """torch.matmul and two F.cross_entropy calls: (forward, backward by
    autograd on a graph built once)."""
    labels = torch.arange(img.shape[0], device=img.device)

    def loss_of(i, t, n):
        logits = n.exp() * (i @ t.T)
        return (F.cross_entropy(logits, labels)
                + F.cross_entropy(logits.T, labels)) / 2

    leaves = [x.clone().requires_grad_() for x in (img, txt, nlt)]
    loss = loss_of(*leaves)
    return (lambda: loss_of(img, txt, nlt),
            lambda: torch.autograd.grad(loss, leaves, retain_graph=True))


def phase_infonce_kernels():
    gen = torch.Generator().manual_seed(8)
    nlt = torch.tensor(math.log(1 / 0.07), device="cuda")
    out = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    for B in INFONCE_BATCHES:
        E = INFONCE_E
        x = torch.randn(2, B, E, generator=gen)
        img, txt = (l2_normalize(x, dim=-1)).cuda().unbind(0)
        g = torch.tensor(1.0, device="cuda")
        loss, lse_i, lse_t, metrics = fused_infonce_forward(img, txt, nlt)
        leaves = [t.clone().requires_grad_() for t in (img, txt, nlt)]
        loss_w, lse_i_w, lse_t_w, m_w = infonce_reference(*leaves)
        grads_w = torch.autograd.grad(loss_w, leaves)
        grads = fused_infonce_backward(img, txt, nlt, lse_i, lse_t, g)
        torch.cuda.synchronize()
        loss_w, lse_i_w, lse_t_w = (t.detach()
                                    for t in (loss_w, lse_i_w, lse_t_w))
        rel = abs(float(loss) - float(loss_w)) / abs(float(loss_w))
        lse_err = max(float((lse_i - lse_i_w).abs().max()),
                      float((lse_t - lse_t_w).abs().max()))
        acc_same = torch.equal(metrics[:2], m_w[:2])
        ent_rel = float(((metrics[2:] - m_w[2:]).abs() / m_w[2:].abs()).max())
        log(f"  K4 forward B={B} E={E}: loss {float(loss):.6f} rel err "
            f"{rel:.3g}, lse max abs err {lse_err:.3g}, accuracies "
            f"{metrics[:2].tolist()} (plain {m_w[:2].tolist()}), entropies "
            f"rel err {ent_rel:.3g}")
        if not (rel <= 1e-5 and lse_err <= 1e-5 and acc_same
                and ent_rel <= 1e-4):
            raise AssertionError(f"K4 forward B={B} against its plain version")
        bwd_err = 0.0
        for name, a, w in zip(("d_img", "d_txt", "d_neg_log_temp"), grads,
                              grads_w):
            err = float((a - w).abs().max())
            bwd_err = max(bwd_err, err)
            log(f"  K4 backward B={B} {name} {tuple(a.shape)}: max abs err "
                f"{err:.3g}")
            if not torch.allclose(a, w, atol=1e-4, rtol=1e-3):
                raise AssertionError(f"K4 backward B={B} {name}: outside "
                                     f"atol 1e-4, rtol 1e-3")
        again = fused_infonce_backward(img, txt, nlt, lse_i, lse_t, g)
        if not all(torch.equal(a, b) for a, b in zip(again, grads)):
            raise AssertionError(f"K4 backward B={B}: a repeated call gave "
                                 f"other bits")
        out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"],
                                        abs(float(loss) - float(loss_w)),
                                        lse_err)
        out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], bwd_err)

        lib_fwd, lib_bwd = infonce_library(img, txt, nlt)
        with torch.no_grad():
            fwd = time_in_turns(
                lambda: fused_infonce_forward(img, txt, nlt),
                lambda: infonce_reference(img, txt, nlt), lib_fwd, 20)
            bwd = time_in_turns(
                lambda: fused_infonce_backward(img, txt, nlt, lse_i, lse_t,
                                               g),
                lambda: infonce_backward_reference(img, txt, nlt, lse_i,
                                                   lse_t, g), lib_bwd, 20)
        act = 4 * 2 * B * E  # bytes of img and txt in f32
        costs = {"fwd": (2 * B * B * E, act + 4 * (2 * B + 5)),
                 "bwd": (6 * B * B * E, 2 * act + 4 * (2 * B + 3))}
        for (key, (flops, nbytes)), (kms, pms, lms) in zip(costs.items(),
                                                           (fwd, bwd)):
            b_ms, b_by = bound(flops, nbytes, PEAK_FLOPS_F32)
            log(f"  K4 {key} B={B} E={E}: kernel {kms:.4f} ms, plain "
                f"{pms:.4f} ms, library {lms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}); kernel {flops / kms / 1e9:.2f} TFLOP/s")
            if B == BATCH:  # the slice's batch
                out[key].update(ms=kms, plain_ms=pms, library_ms=lms,
                                bound_ms=b_ms, bound_by=b_by)
    return out


# ---------------------------------------------------------------- phase 2c

# the int8 blocks of layers 3-4 at 224 px: (name, H, Cin, width, Cout,
# stride, downsample)
Q_BLOCKS_224 = [
    ("layer3.0", 28, 512, 512, 1024, 2, True),
    ("layer3.1", 14, 1024, 512, 1024, 1, False),
    ("layer4.0", 14, 1024, 1024, 2048, 2, True),
    ("layer4.1", 7, 2048, 1024, 2048, 1, False),
]
# (name, H, Cin, width, Cout, stride, downsample, batch): B = 2 gives row
# counts the int8 tile's 128- and 64-row tiles do not divide
Q_BLOCKS_EDGE = [
    ("8x8 stride 1", 8, 256, 128, 256, 1, False, Q_CHECK_BATCH),
    ("8x8 stride 2", 8, 256, 128, 256, 2, True, Q_CHECK_BATCH),
    ("odd 7->4 stride 2", 7, 512, 512, 1024, 2, True, Q_CHECK_BATCH),
    ("8x8 Cin 64", 8, 64, 128, 256, 1, True, Q_CHECK_BATCH),
    ("ragged 9->5 stride 2", 9, 512, 512, 1024, 2, True, 2),
    ("ragged 7x7", 7, 1024, 512, 1024, 1, False, 2),
]
# stages: (name, H, Cin, width, Cout, strides, int8, band); band None = K3a
STAGES_224 = [
    ("layer3 tail", 14, 1024, 512, 1024, [1] * 5, True, None),
    ("layer4", 14, 1024, 1024, 2048, [2, 1, 1], True, None),
    ("layer1", 56, 64, 128, 256, [1, 1, 1], False, 28),
    ("layer3 tail", 14, 1024, 512, 1024, [1] * 5, False, None),
    ("layer4", 14, 1024, 1024, 2048, [2, 1, 1], False, None),
]
# (name, H, Cin, width, Cout, strides, int8, band[, batch: Q_CHECK_BATCH])
STAGES_EDGE = [
    ("8x8 stride-2 head", 8, 256, 128, 256, [2, 1, 1], True, None),
    ("ragged 9->5 stride-2 head", 9, 512, 512, 1024, [2, 1], True, None, 2),
    ("odd 7->4 stride-2 head", 7, 512, 512, 1024, [2, 1], True, None),
    ("16x16, 4 bands", 16, 64, 128, 256, [1, 1, 1], False, 4),
    ("16x16 stride-2 head, 4 bands", 16, 128, 128, 256, [2, 1, 1], False, 4),
    ("16x16, 2 bands", 16, 64, 128, 256, [1, 1, 1], True, 8),
]


def random_block_state(gen, cin, width, cout, has_ds):
    """A BottleneckX state dict (torch names): He-normal convolutions, BN
    scale 1 + 0.1 N(0, 1), bias and mean 0.1 N(0, 1), var U(0.5, 2)."""
    sd = {}
    convs = [("conv1", width, cin, 1), ("conv2", width, width // 32, 3),
             ("conv3", cout, width, 1)]
    bns = [("bn1", width), ("bn2", width), ("bn3", cout)]
    if has_ds:
        convs.append(("downsample.0", cout, cin, 1))
        bns.append(("downsample.1", cout))
    for name, o, i, k in convs:
        sd[f"{name}.weight"] = (torch.randn(o, i, k, k, generator=gen)
                                * math.sqrt(2.0 / (i * k * k)))
    for name, c in bns:
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)
    return sd


def random_q_block(gen, cin, width, cout, has_ds):
    """int8 folded weights of one block on the card (amax as
    tests/test_quant_trunk.py: in 2.0, h1 and h2 1.5, out 2.5)."""
    fw = fold_block_params_q(random_block_state(gen, cin, width, cout,
                                                has_ds), 2.0, 1.5, 1.5, 2.5)
    return {k: v.cuda() for k, v in fw.items()}


def random_codes(gen, batch, H, cin):
    return torch.randint(0, 100, (batch, H, H, cin), generator=gen,
                         dtype=torch.int8).cuda()


def check_codes(what, got, want) -> float:
    """An int8 kernel's codes against its plain version's."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.int8:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} int8")
    diff = (got.int() - want.int()).abs()
    n_diff = int((diff > 0).sum())
    frac = n_diff / diff.numel()
    log(f"  {what:34s} out {tuple(got.shape)}: {n_diff} of {diff.numel()} "
        f"codes differ (max {int(diff.max())}); nonzero "
        f"{float((want > 0).float().mean()):.3f}")
    if int(diff.max()) > 1 or frac >= 1e-3:
        raise AssertionError(f"{what}: {n_diff} codes differ, max "
                             f"{int(diff.max())}")
    return float(diff.max())


def int8_chain(fw, stride):
    """The library chain for K2: torch._int_mm for the 1x1 GEMMs, the cuDNN
    grouped 3x3 on the codes in bf16 (channels-last), torch elementwise
    requantization."""
    width = fw["w1"].shape[0]
    w2 = fw["w2"].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    # torch._int_mm takes B as [K, N]; the fold's 1x1 weights are [N, K]
    wt = {k: fw[k].t().contiguous() for k in ("w1", "w3", "wd") if k in fw}

    def rq(acc, a, b):
        return torch.round(acc.float() * a + b).clamp_(0, 127).to(torch.int8)

    def run(x):
        B, H, W, cin = x.shape
        h1 = rq(torch._int_mm(x.reshape(-1, cin), wt["w1"]), fw["a1"],
                fw["b1"]).reshape(B, H, W, width)
        acc2 = F.conv2d(h1.permute(0, 3, 1, 2).to(torch.bfloat16), w2,
                        stride=stride, padding=1, groups=32)
        h2 = rq(acc2.permute(0, 2, 3, 1).reshape(-1, width), fw["a2"],
                fw["b2"])
        y = torch._int_mm(h2, wt["w3"]).float() * fw["a3"] + fw["b3"]
        if "wd" in fw:
            xs = x[:, ::stride, ::stride].reshape(-1, cin)
            ident = (torch._int_mm(xs, wt["wd"]).float() * fw["ad"]
                     + fw["bd"])
        else:
            ident = x.reshape(-1, cin).float() * fw["ai"]
        Ho = acc2.shape[2]
        return torch.round(y + ident).clamp_(0, 127).to(torch.int8).reshape(
            B, Ho, -1, fw["w3"].shape[0])

    return run


def block_cost(H, cin, width, cout, stride, has_ds, batch):
    """(operations, activation bytes per element size) of one block."""
    Ho = (H - 1) // stride + 1
    ops = 2 * batch * (H * H * cin * width
                       + Ho * Ho * (9 * width // 32 * width + width * cout
                                    + (cin * cout if has_ds else 0)))
    return ops, batch * (H * H * cin + Ho * Ho * cout)


def weight_bytes(fws):
    return sum(t.numel() * t.element_size() for fw in fws
               for t in fw.values())


def stage_inputs(gen, H, cin, width, cout, strides, int8, batch):
    """A stage's input and folded blocks on the card; the head has a
    downsample where it changes the shape."""
    fws = []
    for j, s in enumerate(strides):
        c = cin if j == 0 else cout
        ds = j == 0 and (c != cout or s != 1)
        fws.append(random_q_block(gen, c, width, cout, ds) if int8 else
                   random_block(gen, H, c, width, cout, s, ds, 1)[1])
    if int8:
        return random_codes(gen, batch, H, cin), fws
    x = torch.randn(batch, H, H, cin, generator=gen).clamp_min(0.0)
    return x.to("cuda", torch.bfloat16), fws


def stage_cost(H, cin, width, cout, strides, fws, batch):
    """(operations, bytes): every block's operations without halo
    recompute; one read of the input, one write of the output, the
    weights."""
    ops, h, c = 0, H, cin
    for fw, s in zip(fws, strides):
        ops += block_cost(h, c, width, cout, s, "wd" in fw, batch)[0]
        h, c = (h - 1) // s + 1, cout
    esize = 1 if fws[0]["w1"].dtype == torch.int8 else 2
    nbytes = (esize * batch * (H * H * cin + h * h * cout)
              + weight_bytes(fws))
    return ops, nbytes


def phase_int8_and_stages():
    gen = torch.Generator().manual_seed(3)
    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
           for k in ("K2", "K3a", "K3b")}
    for name, H, cin, width, cout, s, ds, batch in Q_BLOCKS_EDGE:
        fw = random_q_block(gen, cin, width, cout, ds)
        x = random_codes(gen, batch, H, cin)
        res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], check_codes(
            f"K2 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference_q(x, fw, stride=s)))
    for name, H, cin, width, cout, s, ds in Q_BLOCKS_224:
        fw = random_q_block(gen, cin, width, cout, ds)
        x = random_codes(gen, BATCH, H, cin)
        res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], check_codes(
            f"K2 {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference_q(x, fw, stride=s)))
        k, p, li = time_in_turns(
            lambda: fused_bottleneck(x, fw, stride=s),
            lambda: bottleneck_reference_q(x, fw, stride=s),
            lambda: int8_chain(fw, s)(x), 20)
        ops, act = block_cost(H, cin, width, cout, s, ds, BATCH)
        b_ms, b_by = bound(ops, act + weight_bytes([fw]), PEAK_OPS_INT8)
        log(f"  K2 {name} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library int8 chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} TOP/s")
        if name == "layer3.0":  # the one K2 launch of the published plan
            res["K2"].update(ms=k, plain_ms=p, library_ms=li)
            launch_bound(res["K2"], ops, act + weight_bytes([fw]), 1,
                         PEAK_OPS_INT8)
        del x, fw

    def run_stage(what, H, cin, width, cout, strides, int8, band, batch):
        x, fws = stage_inputs(gen, H, cin, width, cout, strides, int8, batch)
        row = "K3a" if band is None else "K3b"

        def kernel():
            return (fused_stage(x, fws, strides) if band is None
                    else fused_stage_banded(x, fws, strides, band))

        def plain():
            return stage_reference(x, fws, strides)

        desc = (f"{row} {'int8' if int8 else 'bf16'} {what}"
                + (f" N={band}" if band else ""))
        got = kernel()
        err = (check_codes if int8 else check)(desc, got, plain())
        res[row]["max_abs_err"] = max(res[row]["max_abs_err"], err)
        # each body runs its blocks' tiles and grouped 3x3: K1's or K2's
        chain = x
        for fw, s in zip(fws, strides):
            chain = fused_bottleneck(chain, fw, stride=s)
        words = int((got != chain).sum())
        unit, k = ("codes", "K2") if int8 else ("words", "K1")
        log(f"  {desc}: {words} of {got.numel()} {unit} differ from its "
            f"blocks' {k} launches (0 expected)")
        if words:
            raise AssertionError(f"{desc}: {words} {unit} from {k}'s chain")
        return x, fws, kernel, plain, desc

    for name, *case in STAGES_EDGE:
        run_stage(name, *case[:7], *case[7:] or [Q_CHECK_BATCH])
    for name, H, cin, width, cout, strides, int8, band in STAGES_224:
        x, fws, kernel, plain, desc = run_stage(
            name, H, cin, width, cout, strides, int8, band, BATCH)
        chains = [int8_chain(fw, st) if int8 else conv_chain(fw, st)
                  for fw, st in zip(fws, strides)]

        def library():
            y = x
            for chain in chains:  # conv_chain gives an NCHW view: back
                y = chain(y) if int8 else chain(y).permute(0, 2, 3, 1)
            return y

        k, p, li = time_in_turns(kernel, plain, library, 10)
        ops, nbytes = stage_cost(H, cin, width, cout, strides, fws, BATCH)
        peak = PEAK_OPS_INT8 if int8 else PEAK_FLOPS
        b_ms, b_by = bound(ops, nbytes, peak)
        log(f"  {desc} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} T(FL)OP/s")
        row = "K3a" if band is None else "K3b"
        if int8 or band is not None:  # the published plan's launches
            r = res[row]
            for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
                r[key] += v
            launch_bound(r, ops, nbytes, 1, peak)
        del x, fws, chains
    for name, r in res.items():
        log(f"  {name} per B={BATCH} forward of the published plan: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"summed per launch ({r['bound_by']})")
    return res


# ------------------------------------------------------------ phases 3 and 4

def make_batch(rng, b):
    """Synthetic uint8 frames and token ids, as bench.py makes them."""
    images = rng.randint(0, 256, (b, 224, 224, 3), np.uint8)
    text = np.zeros((b, MAX_LEN_UTTERANCE), np.int64)
    lens = rng.randint(1, MAX_LEN_UTTERANCE - 1, b)
    text[:, 0] = 2
    for i, n in enumerate(lens):
        text[i, 1:1 + n] = rng.randint(4, VOCAB, n)
        text[i, 1 + n] = 3
    return {"image_u8": torch.from_numpy(images).cuda(),
            "text": torch.from_numpy(text).cuda(),
            "text_len": torch.from_numpy(lens + 2).cuda()}


def flagship_cfg(vit: bool, trunk_int8=False) -> ExperimentConfig:
    """bench.py's flagship (build_flagship, with ``trunk_int8``) or ViT
    flagship (build_vit_flagship), with the augment on."""
    if vit:
        vision = VisionConfig(vit_dino=True)
        text = TextConfig(text_encoder="transformer",
                          pos_embed_type="learned")
    else:
        vision = VisionConfig(cnn_dino=True, frozen_bn="running",
                              trunk_int8=trunk_int8)
        text = TextConfig(text_encoder="embedding")
    return ExperimentConfig(
        model=ModelConfig(
            embedding_dim=512, vocab_size=VOCAB, embedding_type="flat",
            normalize_features=True, fix_temperature=True, temperature=0.07,
            vision=vision, text=text),
        data=DataConfig(augment_frames=True),
        train=TrainConfig(optimizer="AdamW", lr=1e-4, weight_decay=0.1))


def build_vit_slice():
    """(cfg, model, batch) of the ViT slice with its seeded weights."""
    cfg = flagship_cfg(vit=True)
    gen = torch.Generator().manual_seed(0)
    model = CVCL(cfg.model, dtype=torch.bfloat16, device="cuda",
                 generator=gen)
    with torch.no_grad():  # LayerNorm affine and Dense biases that matter
        for m in model.vision_encoder.model.blocks.modules():
            if isinstance(m, LayerNorm):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
            elif isinstance(m, torch.nn.Linear):
                m.bias.copy_(0.02 * torch.randn(m.bias.numel(),
                                                generator=gen))
    return cfg, model, make_batch(np.random.RandomState(0), BATCH)


def drive(model, cfg, batch, launch_counters, show=()):
    """TRAIN_STEPS train steps then one eval step, the kernel launch counts
    (``(wrapper, attribute)`` pairs) set to 0 just before and read just
    after; the train steps' metrics named in ``show`` are printed. Returns
    (state, train_step, launches per counter)."""
    state = init_train_state(model, cfg)
    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    torch.cuda.synchronize()
    for fn, attr in launch_counters:
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    metrics = [train_step(state, batch) for _ in range(TRAIN_STEPS)]
    eval_loss = float(eval_step(batch)["loss"])
    torch.cuda.synchronize()
    launches = [getattr(fn, attr) for fn, attr in launch_counters]
    losses = [float(m["loss"]) for m in metrics]
    for k in show:
        log(f"  {k} {[round(float(m[k]), 6) for m in metrics]}")
    log(f"  losses {losses}, eval loss {eval_loss:.5f} "
        f"({time.perf_counter() - t0:.2f} s for the first {TRAIN_STEPS} "
        f"steps + eval, weight preparation included)")
    if not all(math.isfinite(v) for v in losses + [eval_loss]):
        raise AssertionError(f"non-finite loss: {losses}, eval {eval_loss}")
    return state, train_step, launches


def check_frozen_and_heads(model, frozen, heads):
    """The trunk tensors in ``frozen`` are bit-unchanged, the parameters
    in ``heads`` changed."""
    trunk = model.vision_encoder.model
    for k, v in trunk.state_dict().items():
        if k in frozen and not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen trunk tensor {k} changed")
    named = dict(model.named_parameters())
    for k, v in heads.items():
        if torch.equal(named[k].detach(), v):
            raise AssertionError(f"{k} did not change")
    log(f"  trunk unchanged ({len(frozen)} tensors), {len(heads)} head and "
        f"text tensors updated")


def compare_features(what, kernel, plain, f32):
    """Per-row cosines of the kernel path against the plain bf16 path
    (gated) and against f32 (printed)."""
    cp, cf, cpf = (row_cosines(kernel, plain), row_cosines(kernel, f32),
                   row_cosines(plain, f32))
    log(f"  eval {what}: kernel vs plain bf16 cos min "
        f"{float(cp.min()):.7f} mean {float(cp.mean()):.7f}; kernel vs f32 "
        f"min {float(cf.min()):.7f}; plain bf16 vs f32 min "
        f"{float(cpf.min()):.7f}")
    if not (torch.isfinite(kernel).all()
            and float(cp.min()) >= SLICE_COS_TOL):
        raise AssertionError(f"eval {what}: cosine {float(cp.min()):.7f} < "
                             f"{SLICE_COS_TOL}")


def time_steps(state, train_step, batch, what):
    train_step(state, batch)  # untimed: e.g. a refold after a plan change
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    log(f"  {what} train step B={BATCH}: {step_s * 1e3:.3f} ms, "
        f"{BATCH / step_s:.1f} pairs/s")


def build_resnext_slice(trunk_int8, fused_plan, cfg=None):
    """(cfg, model, batch) of the ResNeXt flagship (or of ``cfg``) with
    seeded weights and non-trivial BN statistics (so the fold matters)."""
    cfg = cfg or flagship_cfg(vit=False, trunk_int8=trunk_int8)
    gen = torch.Generator().manual_seed(0)
    model = CVCL(cfg.model, dtype=torch.bfloat16, device="cuda",
                 generator=gen, fused_plan=fused_plan)
    with torch.no_grad():
        for m in model.vision_encoder.model.modules():
            if isinstance(m, InferenceBN):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=gen))
    return cfg, model, make_batch(np.random.RandomState(0), BATCH)


def frozen_and_heads(model):
    """Copies of the trunk's tensors (amax buffers included) and of the
    head and text parameters, before the steps."""
    trunk = model.vision_encoder.model
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if not k.startswith("fc.")}
    heads = {"vision_encoder.model.fc.weight": trunk.fc.weight.detach().clone(),
             "text_encoder.embedding.weight":
                 model.text_encoder.embedding.weight.detach().clone()}
    return frozen, heads


def phase_resnext_slice():
    cfg, model, batch = build_resnext_slice(False, ("blocks",) * 4)
    trunk = model.vision_encoder.model
    frozen, heads = frozen_and_heads(model)

    state, train_step, (launches,) = drive(
        model, cfg, batch, [(fused_bottleneck, "launches")])
    forwards = TRAIN_STEPS + 1
    log(f"  K1 launches {launches} over {forwards} forwards")
    if launches != 16 * forwards:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{16 * forwards}")
    check_frozen_and_heads(model, frozen, heads)

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(pooled):
            f = l2_normalize(trunk.fc(pooled), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        pooled = [trunk.forward_folded(img_bf16)["pooled"],
                  trunk.forward_conv(img_bf16)["pooled"],
                  trunk.forward_conv(img_f32)["pooled"]]
        compare_features("pooled", *pooled)
        compare_features("logits", *map(logits, pooled))

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        trunk_k = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        trunk_p = time_ms(lambda: trunk.forward_conv(img_aug), 10)
    log(f"  trunk forward B={BATCH}: K1 path {trunk_k:.3f} ms, plain bf16 "
        f"conv path {trunk_p:.3f} ms")
    time_steps(state, train_step, batch, "ResNeXt")
    return launches


def vit_frozen_and_heads(model):
    """Copies of the ViT's tensors and of the head and text parameters,
    before the steps."""
    trunk = model.vision_encoder.model
    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if not k.startswith("head.")}
    layer = "text_encoder.transformer_encoder.layers.0."
    named = dict(model.named_parameters())
    heads = {k: named[k].detach().clone() for k in (
        "vision_encoder.model.head.weight", "text_encoder.embedding.weight",
        "text_encoder.pos_embed", layer + "self_attn.in_proj_weight",
        layer + "linear1.weight", layer + "norm2.weight")}
    return frozen, heads


def phase_vit_slice():
    cfg, model, batch = build_vit_slice()
    trunk = model.vision_encoder.model
    frozen, heads = vit_frozen_and_heads(model)
    # the state phase 6 restarts every configuration from
    start = {k: v.clone() for k, v in model.state_dict().items()}

    state, train_step, launches = drive(
        model, cfg, batch, [(fused_block_attention, "launches"),
                            (fused_mlp, "launches")])
    forwards = TRAIN_STEPS + 1
    log(f"  K5 launches {launches[0]}, K6 launches {launches[1]} over "
        f"{forwards} forwards")
    if launches != [VIT_DEPTH * forwards] * 2:
        raise AssertionError(f"K5/K6 launched {launches} times, expected "
                             f"{VIT_DEPTH * forwards} each")
    check_frozen_and_heads(model, frozen, heads)

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(cls):
            f = l2_normalize(trunk.head(cls), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        cls = [trunk(img_bf16), trunk.forward_plain(img_bf16),
               trunk.forward_plain(img_f32)]
        compare_features("CLS", *cls)
        compare_features("logits", *map(logits, cls))

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        vit_k = time_ms(lambda: trunk(img_aug), 5)
        vit_p = time_ms(lambda: trunk.forward_plain(img_aug), 5)
    log(f"  ViT forward B={BATCH}: K5/K6 path {vit_k:.3f} ms, plain bf16 "
        f"path {vit_p:.3f} ms")
    time_steps(state, train_step, batch, "ViT")
    return launches, (cfg, model, batch, start)


def phase_vit_configs(cfg, model, batch, start):
    """Phase 4's model in each configuration of VIT_CONFIGS, each started
    from phase 4's initial weights (``start``), so that every
    configuration's eval gates are taken where phase 4's are: after 3 steps
    on one batch (training on from the last configuration sharpens the
    logits, and with them the bf16 noise the logits gate sees). Returns the
    launches of each ViT kernel in the configuration that runs it."""
    trunk = model.vision_encoder.model
    forwards = TRAIN_STEPS + 1
    counters = [(fn, "launches") for fn in VIT_KERNELS.values()]
    launches = {}
    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
    for name, (kernels, per_forward) in VIT_CONFIGS.items():
        log(f"  -- {name}: {kernels}")
        model.load_state_dict(start)
        trunk.vit_kernels = kernels
        frozen, heads = vit_frozen_and_heads(model)
        state, train_step, counts = drive(model, cfg, batch, counters)
        got = dict(zip(VIT_KERNELS, counts))
        want = {k: per_forward.get(k, 0) * forwards for k in VIT_KERNELS}
        log(f"  launches over {forwards} forwards: {got}")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        launches.update({k: got[k] for k in per_forward if k[:2] in
                         ("K7", "K8")})
        check_frozen_and_heads(model, frozen, heads)

        with torch.no_grad():
            txt, _ = model.encode_text(batch["text"], batch["text_len"])

            def logits(cls):
                f = l2_normalize(trunk.head(cls), dim=1)
                return model.similarity(f, txt) * model.logit_scale()

            kern = trunk(img_bf16)
            with plain_kernels():
                plain = trunk(img_bf16)
            blocks = trunk.forward_plain(img_bf16)
            f32 = trunk.forward_plain(img_f32)
            for what, ref in (("its plain versions", plain),
                              ("the plain bf16 blocks", blocks)):
                log(f"  against {what}:")
                cls = [kern, ref, f32]
                compare_features("CLS", *cls)
                compare_features("logits", *map(logits, cls))
            fwd = time_ms(lambda: trunk(img_aug), 5)
        log(f"  ViT forward B={BATCH}, {name}: {fwd:.3f} ms")
        time_steps(state, train_step, batch, f"ViT {name}")
    vit_steps_in_turns(cfg, model, batch, start)
    trunk.vit_kernels = ViTKernels()
    return launches


def vit_steps_in_turns(cfg, model, batch, start):
    """The ViT train step of each configuration of VIT_TURNS (default: K5
    + K6; attn=1: K8a + K6; attn=pairs: K8b + K6; attn=qkv: K8c + K6;
    whole_block: K7), each from phase 4's weights with an optimizer state
    of its own, timed in turns (the list, then the list reversed;
    TIMED_STEPS steps a turn) on one model whose ``vit_kernels`` is
    switched before each turn."""
    trunk = model.vision_encoder.model
    model.load_state_dict(start)
    runs = {}
    for name, kernels in VIT_TURNS.items():
        trunk.vit_kernels = kernels
        state, step = init_train_state(model, cfg), make_train_step(model, cfg)
        step(state, batch)  # untimed: first use of the configuration
        runs[name] = (kernels, state, step)
    times = collections.defaultdict(list)
    for name in list(VIT_TURNS) + list(VIT_TURNS)[::-1]:
        kernels, state, step = runs[name]
        trunk.vit_kernels = kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    for name, ms in times.items():
        log(f"  ViT train step B={BATCH} in turns, {name}: "
            f"{' / '.join(f'{t:.3f}' for t in ms)} ms (mean "
            f"{sum(ms) / len(ms):.3f})")


@contextlib.contextmanager
def plain_kernels():
    """The trunks' kernels replaced by their plain versions, on CUDA tensors
    (the wrappers themselves take those only for CPU tensors)."""
    def block(x, fw, stride=1):
        return block_reference(x, fw, stride=stride)

    def stage(x, fws, strides, band=None):
        return stage_reference(x, fws, strides)

    plain = {
        vision_resnext: {"fused_bottleneck": block, "fused_stage": stage,
                         "fused_stage_banded": stage},
        vision_vit: {"fused_block_attention": block_attention_reference,
                     "fused_mlp": mlp_reference,
                     "fused_vit_block": vit_block_reference,
                     "fused_attention": attention_reference,
                     "fused_attention_pairs": attention_pairs_reference,
                     "fused_qkv_attention_pairs":
                         qkv_attention_pairs_reference}}
    saved = [(m, n, getattr(m, n)) for m, fns in plain.items() for n in fns]
    for m, fns in plain.items():
        for n, fn in fns.items():
            setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def phase_published_flagship():
    cfg, model, batch = build_resnext_slice(MIXED, None)
    trunk = model.vision_encoder.model
    log(f"  plans: int8 {trunk.int8_plan}, kernels {trunk.fused_plan}")
    t0 = time.perf_counter()
    calibrate_trunk(model, batch)
    torch.cuda.synchronize()
    log(f"  calibrated on 32 augment-off frames in "
        f"{time.perf_counter() - t0:.2f} s: stem_amax "
        f"{float(trunk.stem_amax):.4f}, layer3.0 h1_amax "
        f"{float(trunk.layer3[0].h1_amax):.4f}, layer4.2 out_amax "
        f"{float(trunk.layer4[2].out_amax):.4f}")
    frozen, heads = frozen_and_heads(model)

    counters = [(fused_bottleneck, "launches"),
                (fused_bottleneck, "launches_q"),
                (fused_stage, "launches"), (fused_stage_banded, "launches")]
    state, train_step, launches = drive(model, cfg, batch, counters)
    forwards = TRAIN_STEPS + 1
    want = [4 * forwards, forwards, 2 * forwards, forwards]
    log(f"  launches over {forwards} forwards: K1 {launches[0]}, K2 "
        f"{launches[1]}, K3a {launches[2]}, K3b {launches[3]}")
    if launches != want:
        raise AssertionError(f"K1/K2/K3a/K3b launched {launches} times, "
                             f"expected {want}")
    check_frozen_and_heads(model, frozen, heads)

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(pooled):
            f = l2_normalize(trunk.fc(pooled), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        kernels = trunk.forward_folded(img_bf16)["pooled"]
        with plain_kernels():
            plain = trunk.forward_folded(img_bf16)["pooled"]
        f32 = trunk.forward_conv(img_f32)["pooled"]
        pooled = [kernels, plain, f32]
        compare_features("pooled", *pooled)
        compare_features("logits", *map(logits, pooled))
        cos_f32 = float(row_cosines(kernels, f32).min())
        log(f"  int8 plan pooled vs the f32 conv path: per-row cosine min "
            f"{cos_f32:.7f} (gate > 0.99)")
        if not cos_f32 > 0.99:
            raise AssertionError(f"pooled cosine vs f32 {cos_f32:.7f}")

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        t_int8 = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        plans = trunk.int8_plan, trunk.fused_plan
        trunk.int8_plan, trunk.fused_plan = (False,) * 4, ("blocks",) * 4
        t_k1 = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        trunk.int8_plan, trunk.fused_plan = plans
        t_conv = time_ms(lambda: trunk.forward_conv(img_aug), 10)
    log(f"  trunk forward B={BATCH}: int8 published plan {t_int8:.3f} ms, "
        f"bf16 per-block K1 path {t_k1:.3f} ms, plain bf16 conv path "
        f"{t_conv:.3f} ms")
    time_steps(state, train_step, batch, "published flagship")
    return launches, (state, train_step, batch)


# ------------------------------------------------------------------ phase 7

def recipe_cfg(lambda_mm: float, lambda_lm: float) -> ExperimentConfig:
    """configs/saycam_contrastive.py with the lstm text encoder (lambda_mm
    1), saycam_joint.py (0.5 and 0.5) or saycam_lm.py (lambda_lm 1) on
    phase 5's published trunk: dropout_i 0.5 (configs/_base.py), flat
    head, fixed T = 0.07, tied LM head with bias, unused terms skipped."""
    cfg = flagship_cfg(vit=False, trunk_int8=MIXED)
    cfg.model.text = TextConfig(text_encoder="lstm", dropout_i=0.5)
    cfg.train.lambda_mm, cfg.train.lambda_lm = lambda_mm, lambda_lm
    cfg.train.optimize_unused = True
    return cfg


def build_lstm_slice():
    """(cfg, model, batch) of phase 7a: the published trunk, seeded and
    calibrated as in phase 5, with the LSTM text encoder."""
    cfg, model, batch = build_resnext_slice(MIXED, None, recipe_cfg(1.0, 0.0))
    calibrate_trunk(model, batch)
    return cfg, model, batch


def lstm_heads(model):
    named = dict(model.named_parameters())
    return {k: named[k].detach().clone() for k in (
        "vision_encoder.model.fc.weight", "text_encoder.embedding.weight",
        "text_encoder.lstm.weight_hh_l0", "language_model.output_layer.bias")}


def make_lm_batch(rng, b, length):
    """Token ids in a window of ``length`` steps: SOS, words, EOS, PAD."""
    text = np.zeros((b, length), np.int64)
    lens = rng.randint(1, length - 1, b)
    lens[0] = length - 2
    text[:, 0] = 2
    for i, n in enumerate(lens):
        text[i, 1:1 + n] = rng.randint(4, VOCAB, n)
        text[i, 1 + n] = 3
    return {"text": torch.from_numpy(text).cuda(),
            "text_len": torch.from_numpy(lens + 2).cuda()}


def phase_lstm_slice():
    """7a: the LSTM contrastive recipe with fused_lstm None and True from
    the same weights, gated against each other; the biLSTM; infonce_loss
    (K4) on the eval features. 7b: the joint recipe and beam search. 7c:
    the LM recipe at L = 64. Returns the K9 launches and K4's forward and
    backward launches, counted from 0 over the whole phase."""
    cfg, model, batch = build_lstm_slice()
    frozen, _ = frozen_and_heads(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    forwards = TRAIN_STEPS + 1
    counters = [(lstm_fused, "launches"),
                (fused_infonce_with_metrics, "launches"),
                (fused_infonce_with_metrics, "launches_bwd")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    total = [0, 0, 0]
    img_eval = augment_batch(batch["image_u8"], augment=False,
                             dtype=torch.bfloat16)
    evals = {}
    for fused in (None, True):
        log(f"  -- 7a lstm contrastive, fused_lstm={fused}")
        model.load_state_dict(start)
        model.text_encoder.fused_lstm = fused
        heads = lstm_heads(model)
        del heads["language_model.output_layer.bias"]  # no LM term
        state, train_step, (k9,) = drive(model, cfg, batch,
                                         [(lstm_fused, "launches")])
        want = forwards if fused else 0
        log(f"  K9 launches {k9} over {forwards} forwards")
        if k9 != want:
            raise AssertionError(f"fused_lstm={fused}: K9 launched {k9} "
                                 f"times, expected {want}")
        total[0] += k9
        check_frozen_and_heads(model, frozen, heads)
        with torch.no_grad():
            out = model.joint_forward(img_eval, batch["text"],
                                      batch["text_len"])
            txt, _ = model.encode_text(batch["text"], batch["text_len"])
            metrics = make_eval_step(model, cfg)(batch)
        evals[fused] = (out["image_features"], txt, out["logits_per_image"],
                        metrics)
        time_steps(state, train_step, batch, f"LSTM fused_lstm={fused}")
    (_, txt0, log0, _), (img1, txt1, log1, m1) = evals[None], evals[True]
    for what, a, b, tol in (("text features", txt1, txt0, COS_TOL),
                            ("logits", log1, log0, SLICE_COS_TOL)):
        cos = row_cosines(a, b)
        log(f"  eval {what}: fused_lstm=True against None: per-row cos min "
            f"{float(cos.min()):.7f} (gate >= {tol})")
        if not (torch.isfinite(a).all() and float(cos.min()) >= tol):
            raise AssertionError(f"7a eval {what}: cosine "
                                 f"{float(cos.min()):.7f} < {tol}")

    # K4 through the entry point on 7a's eval features
    nlt = model.logit_neg_log_temperature.detach()
    leaves = [t.detach().clone().requires_grad_() for t in (img1, txt1, nlt)]
    loss_k = infonce_loss(*leaves)
    grads_k = torch.autograd.grad(loss_k, leaves)
    plain = [t.detach().clone().requires_grad_() for t in (img1, txt1, nlt)]
    logits = plain[2].exp() * (plain[0] @ plain[1].T)
    loss_p, _ = contrastive_loss_from_logits(logits, logits.T)
    grads_p = torch.autograd.grad(loss_p, plain)
    step_loss = float(m1["infonce_loss"])
    rel = abs(float(loss_k) - step_loss) / abs(step_loss)
    log(f"  infonce_loss (K4) on the eval features {float(loss_k):.7f}, the "
        f"eval step's infonce_loss {step_loss:.7f}: rel err {rel:.3g}")
    if not rel <= 1e-5:
        raise AssertionError(f"K4 loss {float(loss_k)} != the step's "
                             f"{step_loss}")
    for name, a, b in zip(("d_img", "d_txt", "d_neg_log_temp"), grads_k,
                          grads_p):
        err = float((a - b).abs().max())
        log(f"  K4 {name} against autograd through the plain loss: max abs "
            f"err {err:.3g}")
        if not torch.allclose(a, b, atol=1e-4, rtol=1e-3):
            raise AssertionError(f"K4 {name}: outside atol 1e-4, rtol 1e-3")

    # the biLSTM encoder: one eval forward, both directions through K9
    bi_cfg = recipe_cfg(1.0, 0.0)
    bi_cfg.model.text.text_encoder = "bilstm"
    bi = TextEncoder(bi_cfg.model, device="cuda",
                     generator=torch.Generator().manual_seed(3),
                     fused_lstm=True)
    before = lstm_fused.launches
    with torch.no_grad():
        feats, _ = bi(batch["text"], batch["text_len"])
        n_bi = lstm_fused.launches - before
        bi.fused_lstm = False
        feats_plain, _ = bi(batch["text"], batch["text_len"])
    cos = row_cosines(feats, feats_plain)
    log(f"  biLSTM eval forward: {n_bi} K9 launches; features against the "
        f"plain scan: per-row cos min {float(cos.min()):.7f}")
    if n_bi != 2 or float(cos.min()) < COS_TOL:
        raise AssertionError(f"biLSTM: {n_bi} K9 launches (expected 2), "
                             f"cos {float(cos.min()):.7f}")
    total[0] += n_bi

    log("  -- 7b joint recipe (lambda_mm = lambda_lm = 0.5), fused_lstm=True")
    cfg_b = recipe_cfg(0.5, 0.5)
    model.load_state_dict(start)
    model.text_encoder.fused_lstm = True
    heads = lstm_heads(model)
    state, train_step, (k9,) = drive(model, cfg_b, batch,
                                     [(lstm_fused, "launches")],
                                     show=("infonce_loss", "ce_loss",
                                           "ce_loss_wo_sos",
                                           "ce_loss_wo_sos_eos", "n_tokens"))
    log(f"  K9 launches {k9} over {forwards} forwards")
    if k9 != forwards:
        raise AssertionError(f"7b: K9 launched {k9} times, expected "
                             f"{forwards}")
    total[0] += k9
    check_frozen_and_heads(model, frozen, heads)
    time_steps(state, train_step, batch, "joint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq, scores = model.beam_search_decode(8, beam_width=3, decode_length=25)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    # a row returns its finished hypotheses, padded with empty slots
    # (score NEG_INF), or its alive beams when none finished
    found = int((scores > NEG_INF / 2).sum())
    log(f"  beam search, 8 sequences, width 3, length 25: {beam_s * 1e3:.1f} "
        f"ms; best: {seq[0, 0, :12].tolist()}..., best scores "
        f"{scores[:, 0].tolist()}; {found} of 24 slots hold a hypothesis")
    if not (seq.shape == (8, 3, 26) and bool((seq[:, 0, 0] == 2).all())
            and bool((scores[:, 0] > NEG_INF / 2).all())):
        raise AssertionError(f"beam search: {tuple(seq.shape)}, scores "
                             f"{scores.tolist()}")

    log(f"  -- 7c LM recipe (lambda_mm = 0) at L = {LM_LEN}, fused_lstm=None")
    cfg_c = recipe_cfg(0.0, 1.0)
    model.load_state_dict(start)
    model.text_encoder.fused_lstm = None
    heads = lstm_heads(model)
    lm_batch = make_lm_batch(np.random.RandomState(5), BATCH, LM_LEN)
    state, train_step, (k9,) = drive(model, cfg_c, lm_batch,
                                     [(lstm_fused, "launches")],
                                     show=("ce_loss", "n_tokens"))
    log(f"  K9 launches {k9} over {forwards} forwards")
    if k9 != forwards:
        raise AssertionError(f"7c: K9 launched {k9} times, expected "
                             f"{forwards}")
    total[0] += k9
    check_frozen_and_heads(model, frozen, heads)
    time_steps(state, train_step, lm_batch, f"LM L={LM_LEN}")
    total[1:] = [fused_infonce_with_metrics.launches,
                 fused_infonce_with_metrics.launches_bwd]
    log(f"  phase 7 launches: K9 {total[0]}, K4 forward {total[1]}, K4 "
        f"backward {total[2]}")
    return total


# ---------------------------------------------------------------- phase 2f

# the transport blocks and stages of the "t" plan at 224 px: (name, H, Cin,
# width, Cout, stride(s), downsample or band, per forward)
T_BLOCKS_224 = [
    ("layer2.0", 56, 256, 256, 512, 2, True, 1),
    ("layer2.1", 28, 512, 256, 512, 1, False, 3),
    ("layer3.0", 28, 512, 512, 1024, 2, True, 1),
]
T_STAGES_224 = [
    ("layer3 tail", 14, 1024, 512, 1024, [1] * 5, None),
    ("layer4", 14, 1024, 1024, 2048, [2, 1, 1], None),
    ("layer1", 56, 64, 128, 256, [1, 1, 1], 28),
]
# K10b: (name, B, H, Cin, width, Cout, stride, downsample, Bc, hh); hh None
# = the TPU package's default band; every block shape at B = 8, then layer
# 2's head at the slice's batch (timed)
TILES_CASES = [
    ("tests/test_hwbc_kernels.py:74", 32, 16, 128, 256, 512, 2, True, 16,
     2)] + [
    (name, 8, H, cin, width, cout, s, ds, 8, (H - 1) // s + 1)
    for name, H, cin, width, cout, s, ds, _ in BLOCKS_224] + [
    ("layer2.0", BATCH, 56, 256, 256, 512, 2, True, 16, None)]


def random_t_block(gen, cin, width, cout, has_ds):
    """int8-transport folded weights of one block on the card (amax as
    tests/test_quant_trunk.py:228: in 2.0, out 2.5)."""
    fw = fold_block_params_t(random_block_state(gen, cin, width, cout,
                                                has_ds), 2.0, 2.5)
    return {k: v.cuda() for k, v in fw.items()}


def transport_chain(fw, stride):
    """The library chain for K10a: the codes as bf16 (the input scale rides
    in w1 and wd), cuDNN bf16 convolutions channels-last, then the output
    scale and the rounding as torch elementwise ops."""
    cl = torch.channels_last

    def conv_w(w):  # [in, out] -> [out, in, 1, 1]
        return w.t()[:, :, None, None].contiguous(memory_format=cl)

    cw = {k: conv_w(fw[k]) for k in ("w1", "w3", "wd") if k in fw}
    w2 = fw["w2"].permute(3, 2, 0, 1).contiguous(memory_format=cl)
    b1, b2 = fw["b1"].to(torch.bfloat16), fw["b2"].to(torch.bfloat16)

    def run(x):
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # NCHW view, codes
        h = F.relu(F.conv2d(xc, cw["w1"], b1))
        h = F.relu(F.conv2d(h, w2, b2, stride=stride, padding=1, groups=32))
        y = F.conv2d(h, cw["w3"]).float().permute(0, 2, 3, 1)
        y = y * fw["a3"] + fw["b3"]
        if "wd" in cw:
            ident = (F.conv2d(xc, cw["wd"], stride=stride).float()
                     .permute(0, 2, 3, 1) * fw["ad"] + fw["bd"])
        else:
            ident = x.float() * fw["ai"]
        return torch.round(y + ident).clamp_(0, 127).to(torch.int8)

    return run


def check_transport_stage(what, got, x, fws, strides) -> float:
    """A transport stage's codes: equal to the chain of its blocks' K10a
    launches (the same tile routines in the same order), each of those
    within check_codes' envelope of its plain version on the same input,
    and the whole against the plain chain at cosine >= 0.9999 (a code that
    one rounding moves rides the residual path into the next block, so the
    chain's differences add up; their count is printed). Returns the max
    abs error against the plain chain, in codes."""
    y = x
    for j, (fw, st) in enumerate(zip(fws, strides)):
        want = bottleneck_reference_t(y, fw, stride=st)
        y = fused_bottleneck(y, fw, stride=st)
        check_codes(f"{what} block {j}", y, want)
    torch.cuda.synchronize()
    same = int((got != y).sum())
    log(f"  {what}: {same} codes differ from the chain of K10a block "
        f"launches (0 expected)")
    if same:
        raise AssertionError(f"{what}: {same} codes differ from the "
                             f"per-block kernels")
    want = stage_reference(x, fws, strides)
    diff = (got.int() - want.int()).abs()
    cos = cosine(got, want)
    log(f"  {what:34s} against its plain chain: {int((diff > 0).sum())} of "
        f"{diff.numel()} codes differ (max {int(diff.max())}), cos "
        f"{cos:.7f}")
    if not cos >= COS_TOL:
        raise AssertionError(f"{what}: cos {cos:.7f} against the plain chain")
    return float(diff.max())


def phase_transport_kernels():
    """K10a (block, stage, banded stage), K10b and K11 against their plain
    versions, then timed beside the plain versions, the library calls and
    the bounds. Returns the kernel rows (launches filled in by phase 8)."""
    gen = torch.Generator().manual_seed(6)
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
            for k in ("K10a block", "K10a stage", "K10a banded")}
    for name, H, cin, width, cout, s, ds, count in T_BLOCKS_224:
        fw = random_t_block(gen, cin, width, cout, ds)
        x = random_codes(gen, BATCH, H, cin)
        r = rows["K10a block"]
        r["max_abs_err"] = max(r["max_abs_err"], check_codes(
            f"K10a {name}", fused_bottleneck(x, fw, stride=s),
            bottleneck_reference_t(x, fw, stride=s)))
        k, p, li = time_in_turns(
            lambda: fused_bottleneck(x, fw, stride=s),
            lambda: bottleneck_reference_t(x, fw, stride=s),
            lambda: transport_chain(fw, s)(x), 20)
        ops, act = block_cost(H, cin, width, cout, s, ds, BATCH)
        b_ms, b_by = launch_bound(r, ops, act + weight_bytes([fw]), count)
        log(f"  K10a {name} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} TFLOP/s")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            r[key] += count * v
        del x, fw

    for name, H, cin, width, cout, strides, band in T_STAGES_224:
        fws = []
        for j, st in enumerate(strides):
            c = cin if j == 0 else cout
            fws.append(random_t_block(gen, c, width, cout,
                                      j == 0 and (c != cout or st != 1)))
        x = random_codes(gen, BATCH, H, cin)
        row = "K10a stage" if band is None else "K10a banded"

        def kernel():
            return (fused_stage(x, fws, strides) if band is None
                    else fused_stage_banded(x, fws, strides, band))

        def plain():
            return stage_reference(x, fws, strides)

        desc = f"{row} {name}" + (f" N={band}" if band else "")
        rows[row]["max_abs_err"] = max(
            rows[row]["max_abs_err"],
            check_transport_stage(desc, kernel(), x, fws, strides))
        chains = [transport_chain(fw, st) for fw, st in zip(fws, strides)]

        def library():
            y = x
            for chain in chains:
                y = chain(y)
            return y

        k, p, li = time_in_turns(kernel, plain, library, 10)
        ops, nbytes = stage_cost(H, cin, width, cout, strides, fws, BATCH)
        nbytes -= BATCH * (H * H * cin + (H // strides[0]) ** 2 * cout)
        r = rows[row]  # int8 activations: 1 byte each
        b_ms, b_by = launch_bound(r, ops, nbytes)
        log(f"  {desc} B={BATCH}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"library chain {li:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"kernel {ops / k / 1e9:.1f} TFLOP/s")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            r[key] += v
        del x, fws, chains
    for name, r in rows.items():
        log(f"  {name} per B={BATCH} forward of the \"t\" plan: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms summed "
            f"per launch ({r['bound_by']})")

    # K10b: K1's function in one launch, h1 and h2 in shared memory
    for name, B, H, cin, width, cout, s, ds, Bc, hh in TILES_CASES:
        hh = hh or default_band(H, cin, (H - 1) // s + 1, s, Bc)
        x, fw = random_block(gen, H, cin, width, cout, s, ds, B)
        before = fused_bottleneck_tiles.launches
        got = fused_bottleneck_tiles(x, fw, s, Bc, hh)
        if fused_bottleneck_tiles.launches != before + 1:
            raise AssertionError(f"K10b {name}: "
                                 f"{fused_bottleneck_tiles.launches - before}"
                                 f" launches, expected 1")
        err = check(f"K10b {name}", got, tiles_reference(x, fw, s, Bc, hh))
        k1 = fused_bottleneck(x, fw, stride=s)
        torch.cuda.synchronize()
        apart = float((got.float() - k1.float()).abs().max() /
                      k1.float().abs().max())
        ulps = (got.view(torch.int16).int() -
                k1.view(torch.int16).int()).abs()
        log(f"  K10b {name}: against K1, max error relative to K1's largest "
            f"output {apart:.3g} (gate < 5e-5, tests/test_hwbc_kernels.py:"
            f"22), {float((ulps > 0).float().mean()):.3g} of the outputs "
            f"differ, by at most {int(ulps.max())} bf16 ulps")
        if not apart < 5e-5:
            raise AssertionError(f"K10b {name}: {apart} from K1")
        if B != BATCH:
            continue
        lib = conv_chain(fw, s)
        k1_ms = [time_ms(lambda: fused_bottleneck(x, fw, stride=s), 10)]
        k, p, li = time_in_turns(
            lambda: fused_bottleneck_tiles(x, fw, s, Bc, hh),
            lambda: tiles_reference(x, fw, s, Bc, hh),
            lambda: lib(x), 10)
        k1_ms.append(time_ms(lambda: fused_bottleneck(x, fw, stride=s), 10))
        ops, act = block_cost(H, cin, width, cout, s, ds, B)
        b_ms, b_by = bound(ops, 2 * act + weight_bytes([fw]))
        log(f"  K10b {name} B={B}: kernel {k:.3f} ms, plain {p:.3f} ms, "
            f"cuDNN bf16 {li:.3f} ms, K1 {k1_ms[0]:.3f} / {k1_ms[1]:.3f} "
            f"ms (before / after), bound {b_ms:.3f} ms ({b_by}); "
            f"{tiles_geometry(H, H, cin, width, cout, s, ds)}")
        rows["K10b"] = dict(max_abs_err=err, ms=k, plain_ms=p, library_ms=li,
                            bound_ms=b_ms, bound_by=b_by)
        del x, fw, lib

    # K11: every conv3 shape of a B = 128 forward
    r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
    for name, H, _, width, cout, s, _, count in BLOCKS_224:
        Ho = (H - 1) // s + 1
        M = BATCH * Ho * Ho
        x = torch.randn(M, width, generator=gen).clamp_min(0).to(
            "cuda", torch.bfloat16)
        w = (torch.randn(width, cout, generator=gen) / width ** 0.5).to(
            "cuda", torch.bfloat16)
        mul = (0.5 + torch.rand(cout, generator=gen)).cuda()
        add = (0.1 * torch.randn(cout, generator=gen)).cuda()
        res = torch.randn(M, cout, generator=gen).to("cuda", torch.bfloat16)
        args = (x, w, mul, add, res)
        r["max_abs_err"] = max(r["max_abs_err"], check(
            f"K11 {name} conv3 M={M}", conv1x1_bn_residual_relu(*args),
            epilogue_reference(*args)))
        if name in ("layer1.0", "layer4.0"):  # the backward
            leaves = [t.clone().requires_grad_() for t in args]
            plain_leaves = [t.clone().requires_grad_() for t in args]
            g = torch.randn(M, cout, generator=gen).to("cuda", torch.bfloat16)
            got = torch.autograd.grad(conv1x1_bn_residual_relu(*leaves),
                                      leaves, g)
            want = torch.autograd.grad(epilogue_reference(*plain_leaves),
                                       plain_leaves, g)
            for gname, a, b in zip(("x", "w", "mul", "add", "residual"), got,
                                   want):
                if not torch.equal(a, b):  # both the plain autograd
                    raise AssertionError(f"K11 {name} d{gname} differs")
            log(f"  K11 {name}: the gradients of x, w, mul, add and the "
                f"residual equal the plain version's autograd")

        def library():
            y = torch.matmul(x, w).float() * mul + add + res.float()
            return torch.relu(y).to(torch.bfloat16)

        k, p, li = time_in_turns(lambda: conv1x1_bn_residual_relu(*args),
                                 lambda: epilogue_reference(*args),
                                 library, 20)
        ops = 2 * M * width * cout
        nbytes = 2 * (M * width + 2 * M * cout + width * cout) + 8 * cout
        b_ms, b_by = launch_bound(r, ops, nbytes, count)
        log(f"  K11 {name} conv3 M={M} Cin={width} Cout={cout}: kernel "
            f"{k:.3f} ms, plain {p:.3f} ms, matmul chain {li:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by})")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", li)):
            r[key] += count * v
        del x, w, res, args
    log(f"  K11 over the 16 conv3 of one B={BATCH} forward: kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, matmul chain "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms summed per "
        f"launch ({r['bound_by']})")
    rows["K11"] = r
    return rows


# ------------------------------------------------------------------ phase 8

T_PLANS = {  # trunk_int8 -> launches per forward by counter
    "t": {"K10a block": 5, "K10a stage": 2, "K10a banded": 1},
    "t,t,1,1": {"K10a block": 4, "K10a banded": 1, "K2": 1, "K3a": 2},
}
T_COUNTERS = {
    "K1": (fused_bottleneck, "launches"), "K2": (fused_bottleneck,
                                                 "launches_q"),
    "K10a block": (fused_bottleneck, "launches_t"),
    "K3a": (fused_stage, "launches"), "K10a stage": (fused_stage,
                                                     "launches_t"),
    "K3b": (fused_stage_banded, "launches"),
    "K10a banded": (fused_stage_banded, "launches_t"),
}


def phase_transport_slice(published):
    """8a/8b: phase 5's published model under trunk_int8 "t" and
    ("t", "t", "q", "q"), calibrated once, 3 train and 1 eval steps each,
    gated as phase 5; then the step times of both and of phase 5's
    (``published``: (state, train_step, batch)) in turns. 8c: the entry
    points of K10b and K11. Returns the launches by kernel row."""
    forwards = TRAIN_STEPS + 1
    launches = collections.Counter()
    timed = {"published \"0,0,1,1\"": published}
    for plan, per_forward in T_PLANS.items():
        log(f"  -- trunk_int8={plan!r}, default kernel plan")
        cfg, model, batch = build_resnext_slice(plan, None)
        trunk = model.vision_encoder.model
        calibrate_trunk(model, batch)
        frozen, heads = frozen_and_heads(model)
        state, train_step, counts = drive(model, cfg, batch,
                                          list(T_COUNTERS.values()))
        got = dict(zip(T_COUNTERS, counts))
        want = {k: per_forward.get(k, 0) * forwards for k in T_COUNTERS}
        log(f"  launches over {forwards} forwards: {got}")
        if got != want:
            raise AssertionError(f"{plan}: launches {got}, expected {want}")
        launches.update({k: v for k, v in got.items() if k[:3] == "K10"})
        check_frozen_and_heads(model, frozen, heads)
        with torch.no_grad():
            img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                     dtype=torch.bfloat16)
            img_f32 = augment_batch(batch["image_u8"], augment=False)
            txt, _ = model.encode_text(batch["text"], batch["text_len"])

            def logits(pooled):
                f = l2_normalize(trunk.fc(pooled), dim=1)
                return model.similarity(f, txt) * model.logit_scale()

            kernels = trunk.forward_folded(img_bf16)["pooled"]
            with plain_kernels():
                plain = trunk.forward_folded(img_bf16)["pooled"]
            f32 = trunk.forward_conv(img_f32)["pooled"]
            compare_features("pooled", kernels, plain, f32)
            compare_features("logits", *map(logits, (kernels, plain, f32)))
            cos_f32 = float(row_cosines(kernels, f32).min())
            log(f"  {plan} pooled vs the f32 conv path: per-row cosine min "
                f"{cos_f32:.7f} (gate > 0.99)")
            if not cos_f32 > 0.99:
                raise AssertionError(f"pooled cosine vs f32 {cos_f32:.7f}")
            img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
            fwd = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        log(f"  trunk forward B={BATCH}, trunk_int8={plan!r}: {fwd:.3f} ms")
        timed[plan] = (state, train_step, batch)
    log("  step times in turns (published, t, t,t,1,1, then back):")
    order = list(timed) + list(timed)[::-1]
    for what in order:
        time_steps(*timed[what], f"trunk_int8={what}")

    log("  -- 8c the entry points of K10b and K11")
    x, fw = random_block(torch.Generator().manual_seed(8), 56, 256, 256, 512,
                         2, True, BATCH)
    fused_bottleneck_tiles.launches = 0
    got = fused_bottleneck_tiles(x, fw, 2)
    n_tiles = fused_bottleneck_tiles.launches
    check("K10b layer2.0 entry point", got, fused_bottleneck(x, fw, 2))
    log(f"  fused_bottleneck_tiles(layer2.0, B={BATCH}, Bc 16, default "
        f"band): {n_tiles} launch(es)")
    if n_tiles != 1:
        raise AssertionError(f"K10b: {n_tiles} launches a call, expected 1")
    launches["K10b"] = n_tiles
    cfg, model, batch = build_resnext_slice(False, None)
    trunk = model.vision_encoder.model
    for block in trunk.blocks():
        block.fused_epilogue = True
    conv1x1_bn_residual_relu.launches = 0
    with torch.no_grad():
        img = augment_batch(batch["image_u8"], augment=False,
                            dtype=torch.bfloat16)
        fused = trunk.forward_conv(img)["pooled"]
        n_k11 = conv1x1_bn_residual_relu.launches
        for block in trunk.blocks():
            block.fused_epilogue = False
        conv = trunk.forward_conv(img)["pooled"]
        cos = row_cosines(fused, conv)
    log(f"  conv path with BottleneckX(fused_epilogue=True): {n_k11} K11 "
        f"launches per forward; pooled against the conv path without it: "
        f"per-row cos min {float(cos.min()):.7f} (gate >= {SLICE_COS_TOL})")
    if n_k11 != 16 or float(cos.min()) < SLICE_COS_TOL:
        raise AssertionError(f"K11: {n_k11} launches, cos "
                             f"{float(cos.min()):.7f}")
    launches["K11"] = n_k11
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"  built {lib_path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):  # registers and spills per kernel
        if "Function properties for" in line and i + 2 < len(lines):
            log(f"  ptxas: ...{line.split('for ')[-1][-44:]}: "
                f"{lines[i + 2].split(': ', 1)[-1]}; {lines[i + 1].strip()}")
    # (name, mangled kernel name, its forms: template arguments -> what)
    passes = {"Lb1EEEv": "one pass", "Lb0EEEv": "two passes"}
    for name, kernel, forms in (
            ("K5 attention", "13attention_mmaILi2E", passes),
            ("Dense tile", "8vit_gemmI", {
                "13RoundThenBias": "RoundThenBias (K5 qkv)",
                "12ResidualBias": "ResidualBias (K5 proj)",
                **{f"BiasGeluFormILi{m}E": f"BiasGelu {g} (probe)"
                   for m, g in enumerate(GELU_MODES)}}),
            ("K6 ping-pong tile", "12vit_pingpongI", {
                **{f"12PingPongGeluILi{m}E": f"fc1, GELU {g}"
                   for m, g in enumerate(GELU_MODES)},
                "16PingPongResidual": "fc2, residual"}),
            ("K7", "16vit_block_kernelI", passes),
            ("K8a", "13attention_mmaILi0E", passes),
            ("K8b", "13attention_mmaILi1E", passes),
            ("K8c", "17qkv_attention_mmaI", passes),
            ("K10b", "16bottleneck_fusedI", {f"Li{cg}EEEv": f"cg {cg}"
                                           for cg in (4, 8, 16, 32)}),
            ("K1 1x1 tile", "9conv_gemmI", CONV_TILE_FORMS),
            ("K2/K3a int8 1x1 tile", "12conv_gemm_s8I", {
                "ILi0E": "conv1", "ILi1E": "conv3, residual",
                "ILi2E": "conv3, downsample"}),
            ("K1 grouped 3x3", "10gconv_haloI", {
                f"ILi{cg}EEEv": f"cg {cg}" for cg in (4, 8, 16, 32)}),
            ("K2 grouped 3x3", "13gconv_halo_s8I", {
                f"ILi{cg}EEEv": f"cg {cg}" for cg in (4, 8, 16, 32)}),
            ("K3a/K3b stage", "17stage_tile_kernelI", {
                **{f"9StageStepELi{cg}E": f"bf16, cg {cg}"
                   for cg in (4, 8, 16, 32)},
                **{f"11StageStepS8ELi{cg}E": f"int8, cg {cg}"
                   for cg in (4, 8, 16, 32)}})):
        found = [i for i, line in enumerate(lines)
                 if "Function properties for" in line and kernel in line]
        if len(found) != len(forms):
            raise AssertionError(f"ptxas reported {len(found)} {kernel} "
                                 f"kernels, expected {len(forms)}")
        for i in found:
            form = next(v for k, v in forms.items() if k in lines[i])
            log(f"  ptxas {name} ({kernel.strip('0123456789I')}, {form}): "
                f"{lines[i + 2].split(': ', 1)[-1]}; {lines[i + 1].strip()}")
        if name[:2] == "K8" or name == "K5 attention":
            log(f"  {name} dynamic shared memory at N = 257: "
                f"{attention_geometry(257, qkv=name == 'K8c').smem} bytes")
    for line in lines:  # a serialized or rescheduled wgmma in K6's tile
        if "vit_pingpong" in line and ("C75" in line or "wgmma" in line):
            log(f"  ptxas K6 ping-pong tile: {line.strip()}")
    # the kernels of K1, K2 and the stage bodies on the wgmma tiles: no
    # spills, no wgmma serialized or waited on by the compiler
    for i, line in enumerate(lines):
        new = any(k in line for k in ("9conv_gemmI", "12conv_gemm_s8I",
                                      "17stage_tile_kernelI",
                                      "10gconv_haloI", "13gconv_halo_s8I"))
        if new and ("C75" in line or "wgmma" in line):
            raise AssertionError(f"ptxas on K1, K2 or K3a/b: {line.strip()}")
        if (new and "Function properties for" in line
                and "0 bytes spill stores, 0 bytes spill loads"
                not in lines[i + 1]):
            raise AssertionError(f"ptxas on K1, K2 or K3a/b: "
                                 f"{line.strip()}: {lines[i + 1].strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = mlp_geometry(BATCH * 257, 768, 3072, sms)
    log(f"  K6 at the ViT slice (M = {BATCH * 257}): {geo}")
    geo = tiles_geometry(56, 56, 256, 256, 512, 2, True)
    log(f"  K10b at layer 2's head: {geo}")
    for name, H, cin, width, cout, stride, ds, _ in (BLOCKS_224[0],
                                                      BLOCKS_224[-2]):
        geo = block_geometry(BATCH, H, H, cin, width, cout, stride, ds, sms)
        log(f"  K1's 1x1 tile at {name} (B = {BATCH}): conv1, conv3 {geo}")
    for name, H, cin, width, cout, stride, ds in Q_BLOCKS_224[::2]:
        geo = block_geometry_s8(BATCH, H, H, cin, width, cout, stride, ds,
                                sms)
        log(f"  K2's int8 tile at {name} (B = {BATCH}): conv1, conv3 {geo}")

    log("phase 2: K1 against its plain version")
    k1 = phase_k1()
    log("phase 2b: K5 and K6 against their plain versions")
    vit_kernels = phase_vit_kernels()
    log("phase 2c: K2, K3a and K3b against their plain versions")
    q = phase_int8_and_stages()
    log("phase 3: the ResNeXt slice, per-block plan")
    k1["launches"] = phase_resnext_slice()
    log("phase 2d: K7, K8a, K8b and K8c against their plain versions")
    vit_kernels.update(phase_vit_more_kernels())
    log("phase 4: the ViT slice")
    (vit_kernels["K5"]["launches"], vit_kernels["K6"]["launches"]), vit = \
        phase_vit_slice()
    log("phase 5: the published flagship, int8 layers 3-4, default plan")
    (_, q["K2"]["launches"], q["K3a"]["launches"],
     q["K3b"]["launches"]), published = phase_published_flagship()
    log("phase 6: the ViT slice in its other kernel configurations")
    for name, n in phase_vit_configs(*vit).items():
        vit_kernels[name]["launches"] = n
    log("phase 2e: K9 and K4 against their plain versions")
    k9 = phase_lstm_kernel()
    k4 = phase_infonce_kernels()
    log("phase 7: the LSTM text encoders and their language model")
    (k9["launches"], k4["fwd"]["launches"],
     k4["bwd"]["launches"]) = phase_lstm_slice()
    log("phase 2f: K10a, K10b and K11 against their plain versions")
    t = phase_transport_kernels()
    log("phase 8: the int8-transport trunk plans, K10b and K11 entry points")
    for name, n in phase_transport_slice(published).items():
        t[name]["launches"] = n

    csrc = "multimodal_baby_tpu_torch/ops/csrc/"
    hwbc = "multimodal_baby_tpu/ops/bottleneck_hwbc.py"
    rows = [("fused_bottleneck", "conv_gemm.cuh", f"{hwbc}:408", k1),
            ("fused_bottleneck_int8", "conv_gemm_s8.cuh", f"{hwbc}:408",
             q["K2"]),
            ("fused_stage", "conv_gemm_s8.cuh", f"{hwbc}:758", q["K3a"]),
            ("fused_stage_banded", "conv_gemm.cuh", f"{hwbc}:1078",
             q["K3b"]),
            ("fused_block_attention", "vit_attention.cu",
             "multimodal_baby_tpu/ops/attention.py:601", vit_kernels["K5"]),
            ("fused_mlp", "vit.cu", "multimodal_baby_tpu/ops/vit_mlp.py:186",
             vit_kernels["K6"]),
            ("fused_vit_block", "vit_block.cu",
             "multimodal_baby_tpu/ops/vit_block.py:130", vit_kernels["K7"]),
            ("fused_attention", "attention.cu",
             "multimodal_baby_tpu/ops/attention.py:90", vit_kernels["K8a"]),
            ("fused_attention_pairs", "attention.cu",
             "multimodal_baby_tpu/ops/attention.py:239", vit_kernels["K8b"]),
            ("fused_qkv_attention_pairs", "attention.cu",
             "multimodal_baby_tpu/ops/attention.py:392", vit_kernels["K8c"]),
            ("fused_infonce_forward", "infonce.cu",
             "multimodal_baby_tpu/ops/infonce.py:145", k4["fwd"]),
            ("fused_infonce_backward", "infonce.cu",
             "multimodal_baby_tpu/ops/infonce.py:171", k4["bwd"]),
            ("lstm_fused", "lstm.cu", "multimodal_baby_tpu/ops/lstm.py:147",
             k9),
            ("fused_bottleneck_transport", "bottleneck.cu", f"{hwbc}:408",
             t["K10a block"]),
            ("fused_stage_transport", "stage.cu", f"{hwbc}:758",
             t["K10a stage"]),
            ("fused_stage_banded_transport", "stage.cu", f"{hwbc}:1078",
             t["K10a banded"]),
            ("fused_bottleneck_tiles", "bottleneck_fused.cu", f"{hwbc}:531",
             t["K10b"]),
            ("conv1x1_bn_residual_relu", "conv_epilogue.cu",
             "multimodal_baby_tpu/ops/conv_epilogue.py:78", t["K11"])]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src,
         "replaces": replaces, **{k: res[k] for k in keys}}
        for name, src, replaces, res in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
