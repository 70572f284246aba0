#!/usr/bin/env python3
"""Where K1's time goes on the 1x1 convolutions' tile (csrc/conv_gemm.cuh).

For each ResNeXt-50 block shape of a B = 128 forward at 224 px
(``chip_smoke.BLOCKS_224``), K1 (``fused_bottleneck``) taken apart into its
three launches (``mmb_bottleneck_bf16_part``: conv1 on the tile, the grouped
3x3 on ``bottleneck.cuh``'s wmma tile, conv3 on the tile with the
downsample as its second K segment where the block has one), each timed
alone beside ``torch.matmul`` on the same GEMM (conv3's A with the
downsample as one [M, width + cin] operand, its strided rows gathered ahead
of the timing), in TFLOP/s, and the whole block. Times are CUDA events over
20 calls after warm-up, in turns (tile, matmul, matmul, tile).

``--check`` first holds each launch alone against its plain version at
small shapes (B = 2 and 3, 7 -> 4 and 8 -> 4 px, stride 1 and 2, with and
without the downsample) and prints, where they differ, which GEMM rows do:
the pattern of the rows names a fault of the TMA's im2col traversal or the
store's clipping. Needs an NVIDIA GPU and the CUDA toolkit:

    python3 scripts/probe_conv_tile.py [--check]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from multimodal_baby_tpu_torch.ops import _build  # noqa: E402
from multimodal_baby_tpu_torch.ops import bottleneck as TB  # noqa: E402

PARTS = {1: "conv1", 2: "grouped 3x3", 3: "conv3"}
CHECKS = [  # (B, H, cin, width, cout, stride, downsample)
    (2, 8, 64, 128, 256, 1, True),
    (3, 7, 256, 128, 256, 1, False),
    (2, 8, 256, 256, 512, 2, True),
    (3, 7, 512, 256, 512, 2, True),
    (2, 4, 1024, 1024, 2048, 2, True),
]


def run_part(part, x, fw, stride, h1, h2, out):
    lib = _build.library()
    B, H, W, cin = x.shape
    width, cout = TB.block_dims(fw)
    code = lib.mmb_bottleneck_bf16_part(
        part, x.data_ptr(), *TB._ptrs(fw, TB._BF16_ORDER), h1.data_ptr(),
        h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout, stride,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"K1 {PARTS[part]}")


def buffers(x, fw, stride):
    B, H, W, _ = x.shape
    width, cout = TB.block_dims(fw)
    Ho, Wo = TB._out_size(H, stride), TB._out_size(W, stride)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=x.device)

    return empty(B, H, W, width), empty(B, Ho, Wo, width), empty(
        B, Ho, Wo, cout)


def report_rows(what, got, want):
    """The max error relative to the largest output, and the GEMM rows
    (pixels) that differ by more than one bf16 rounding."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = (got - want).abs()
    rel = float(err.max() / want.abs().max())
    bad = (err > 1e-2 * want.abs().max()).any(1).nonzero().flatten()
    print(f"  {what}: rel {rel:.3e}; {bad.numel()} of {got.shape[0]} rows "
          f"off" + (f", first {bad[:12].tolist()}" if bad.numel() else ""),
          flush=True)
    return bad.numel() == 0


def check():
    gen = torch.Generator().manual_seed(11)
    ok = True
    for B, H, cin, width, cout, s, ds in CHECKS:
        x, fw = chip_smoke.random_block(gen, H, cin, width, cout, s, ds, B)
        h1, h2, out = buffers(x, fw, s)
        print(f"B={B} H={H} cin={cin} width={width} cout={cout} stride={s} "
              f"downsample={ds}", flush=True)
        want1 = TB._conv1(x, fw, x.dtype)
        run_part(1, x, fw, s, h1, h2, out)
        torch.cuda.synchronize()
        ok &= report_rows("conv1 (h1)", h1, want1)
        h1.copy_(want1)
        want2 = TB._grouped(want1, fw, s, x.dtype)
        run_part(2, x, fw, s, h1, h2, out)
        torch.cuda.synchronize()
        ok &= report_rows("grouped 3x3 (h2)", h2, want2)
        h2.copy_(want2)
        want3 = TB._conv3(want2, x[:, ::s, ::s], fw, x.dtype)
        run_part(3, x, fw, s, h1, h2, out)
        torch.cuda.synchronize()
        ok &= report_rows("conv3 (out)", out, want3)
    return ok


def time_shapes():
    gen = torch.Generator().manual_seed(12)
    B = chip_smoke.BATCH
    total = {k: 0.0 for k in ("conv1", "grouped 3x3", "conv3", "block",
                              "matmul conv1", "matmul conv3")}
    for name, H, cin, width, cout, s, ds, count in chip_smoke.BLOCKS_224:
        x, fw = chip_smoke.random_block(gen, H, cin, width, cout, s, ds, B)
        h1, h2, out = buffers(x, fw, s)
        Ho = TB._out_size(H, s)
        M1, M3 = B * H * H, B * Ho * Ho
        a1 = x.reshape(M1, cin)
        a3 = h2.reshape(M3, width)
        w3 = fw["w3"]
        if ds:  # the downsample as a second K segment, gathered ahead
            a3 = torch.cat([a3, x[:, ::s, ::s].reshape(M3, cin)], 1)
            w3 = torch.cat([w3, fw["wd"]], 0)
        flops = {"conv1": 2 * M1 * cin * width,
                 "grouped 3x3": 2 * M3 * 9 * width // 32 * width,
                 "conv3": 2 * M3 * (width + (cin if ds else 0)) * cout}
        res = {}
        for part, what in PARTS.items():
            t = [chip_smoke.time_ms(
                lambda: run_part(part, x, fw, s, h1, h2, out), 20)]
            if what != "grouped 3x3":
                a, w = (a1, fw["w1"]) if part == 1 else (a3, w3)
                mm = [chip_smoke.time_ms(lambda: torch.matmul(a, w), 20)]
                mm.append(chip_smoke.time_ms(lambda: torch.matmul(a, w), 20))
                res[f"matmul {what}"] = sum(mm) / 2
            t.append(chip_smoke.time_ms(
                lambda: run_part(part, x, fw, s, h1, h2, out), 20))
            res[what] = sum(t) / 2
        res["block"] = chip_smoke.time_ms(
            lambda: TB.fused_bottleneck(x, fw, stride=s), 20)
        parts = []
        for k, v in res.items():
            gemm = k.split(" ", 1)[1] if k.startswith("matmul") else k
            rate = (f" ({flops[gemm] / v / 1e9:.0f} TFLOP/s)"
                    if gemm in flops else "")
            parts.append(f"{k} {v:.4f} ms{rate}")
        line = ", ".join(parts)
        print(f"{name} x{count}: {line}", flush=True)
        for k, v in res.items():
            total[k] += count * v
        del x, fw, h1, h2, out, a1, a3, w3
    print("per B=128 forward (16 blocks): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in total.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="hold each launch against its plain version first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_conv_tile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    if args.check and not check():
        print("probe_conv_tile: a launch disagrees with its plain version",
              file=sys.stderr)
        return 1
    time_shapes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
