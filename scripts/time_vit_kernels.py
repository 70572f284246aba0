#!/usr/bin/env python3
"""Time K5 (``fused_block_attention``) and K6 (``fused_mlp``) at the ViT-B/14
shape of the train step (B = 128, N = 257, C = 768, 12 heads, F = 3072),
each checked against its plain version first.

The package is the one found first on ``sys.path``, so two versions of the
kernels compare in one call by running this script once from each
checkout, in turns (A, B, B, A):

    PYTHONPATH=path/to/checkout python3 scripts/time_vit_kernels.py --tag A
"""

from __future__ import annotations

import argparse
import sys

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.attention import (
    block_attention_reference, fused_block_attention)
from multimodal_baby_tpu_torch.ops.vit_mlp import fused_mlp, mlp_reference

B, N, C, HEADS, F = 128, 257, 768, 12, 3072


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_vit_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g) * sc).to("cuda",
                                                          torch.bfloat16)

    x = rnd(B, N, C)
    attn = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 3 * C, sc=C ** -0.5),
            rnd(3 * C, sc=0.1), rnd(C, C, sc=C ** -0.5), rnd(C, sc=0.1)]
    mlp = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, F, sc=C ** -0.5),
           rnd(F, sc=0.1), rnd(F, C, sc=F ** -0.5), rnd(C, sc=0.1)]
    scale = (C // HEADS) ** -0.5
    runs = {"K5": (lambda: fused_block_attention(x, *attn, HEADS, scale),
                   lambda: block_attention_reference(x, *attn, HEADS, scale)),
            "K6": (lambda: fused_mlp(x, *mlp), lambda: mlp_reference(x, *mlp))}
    with torch.no_grad():
        for name, (kernel, plain) in runs.items():
            got, want = kernel().double(), plain().double()
            rel = float((got - want).abs().max() / want.abs().max())
            cos = float((got * want).sum() / (got.norm() * want.norm()))
            for _ in range(3):
                kernel()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                kernel()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.iters
            print(f"{args.tag} {name} B={B}: {ms:.4f} ms; against the plain "
                  f"version rel {rel:.3e} cos {cos:.9f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
