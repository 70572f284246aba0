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

``--int8`` does the same for K2 (``mmb_bottleneck_s8_part``) at the four
int8 block shapes of layers 3-4 (``chip_smoke.Q_BLOCKS_224``): conv1, the
grouped 3x3 and conv3 (with the downsample's own sums where the block has
one) beside ``torch._int_mm`` on the same GEMMs (two calls for a conv3
with a downsample, whose segments keep apart) and the cuDNN bf16 grouped
3x3 on the codes, in int8 TOP/s; then the int8 stage kernel (K3a) on
layer 3's tail and layer 4 beside builds of ``stage.cu`` whose int8 body
skips some phases' work (``STAGE_PROBES``: only the grid barriers and the
plan remain, or everything but the grouped 3x3), so that the stage's time
splits into its 1x1 GEMMs, its grouped 3x3 and its barriers.

``--transport`` does the same for K10a (``mmb_bottleneck_t_part``) at the 8
block shapes: conv1 on the int8 codes (K1's tile, the codes as its A
operand, rewritten in shared memory as bf16), the grouped 3x3 (K1's
launch) and conv3
(the downsample's own sums over the codes, K2's int8 epilogue), each beside
``torch.matmul`` on the same GEMM in bf16 (TFLOP/s) and beside K1's launch
at the same block shape on bf16 inputs. ``--epilogue`` times K11 at every
conv3 shape of a forward beside ``torch.matmul`` and K1's conv3 launch.

``--check`` first holds each launch alone against its plain version at
small shapes (B = 2 and 3, 7 -> 4 and 8 -> 4 px, stride 1 and 2, with and
without the downsample; int8 also at Cin = 64, transport at Cin = 64 and
96, K11 at M = 1, 7, 200) and prints, where they differ, which GEMM rows
do: the pattern of the rows names a fault of the TMA's im2col traversal or
the store's clipping. Needs an NVIDIA GPU and the CUDA toolkit:

    python3 scripts/probe_conv_tile.py [--check] [--int8 | --transport |
                                        --epilogue]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from multimodal_baby_tpu_torch.ops import _build  # noqa: E402
from multimodal_baby_tpu_torch.ops import bottleneck as TB  # noqa: E402
from multimodal_baby_tpu_torch.ops import conv_epilogue as TE  # noqa: E402
from multimodal_baby_tpu_torch.ops import quant as TQ  # noqa: E402
from multimodal_baby_tpu_torch.ops import stage as TS  # noqa: E402

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


# ------------------------------------------------------------------ int8

Q_CHECKS = [  # (B, H, cin, width, cout, stride, downsample)
    (2, 8, 64, 128, 256, 1, True),
    (3, 7, 256, 128, 256, 1, False),
    (2, 8, 256, 256, 512, 2, True),
    (3, 7, 512, 512, 1024, 2, True),
    (2, 4, 1024, 1024, 2048, 2, True),
    (3, 5, 1024, 512, 1024, 1, False),
]
OUT = ROOT / "build" / "probe_conv_tile"
# the stage body's phases, each a walk that a probe build of stage.cu
# skips: phase -> [(text in stage.cu, its replacement)]
STAGE_PHASES = {
    "1x1 GEMMs": [(f"    stage_conv{k}<CONSUMER>(st, s);\n",
                   f"    if (false) stage_conv{k}<CONSUMER>(st, s);\n")
                  for k in (1, 3)],
    "grouped": [("    stage_gconv<CG>(st, s);\n",
                 "    if (false) stage_gconv<CG>(st, s);\n")],
}
# probe build -> the phases it skips
STAGE_PROBES = {"barriers only": ("1x1 GEMMs", "grouped"),
                "no 1x1 GEMMs": ("1x1 GEMMs",),
                "no grouped 3x3": ("grouped",)}


def run_part_s8(part, x, fw, stride, h1, h2, out):
    lib = _build.library()
    B, H, W, cin = x.shape
    width, cout = TB.block_dims(fw)
    code = lib.mmb_bottleneck_s8_part(
        part, x.data_ptr(), *TB._ptrs(fw, TB._Q_ORDER), h1.data_ptr(),
        h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout, stride,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"K2 {PARTS[part]}")


def buffers_s8(x, fw, stride):
    B, H, W, _ = x.shape
    width, cout = TB.block_dims(fw)
    Ho, Wo = TB._out_size(H, stride), TB._out_size(W, stride)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int8, device=x.device)

    return empty(B, H, W, width), empty(B, Ho, Wo, width), empty(
        B, Ho, Wo, cout)


def plain_parts_s8(x, fw, s):
    """K2's plain version taken apart: h1, h2 and out."""
    B, H, W, cin = x.shape
    width, _ = TB.block_dims(fw)
    h1 = TQ._requant(TQ._exact_dot(x.reshape(-1, cin), fw["w1"]), fw["a1"],
                     fw["b1"]).reshape(B, H, W, width)
    acc2 = TQ._exact_grouped_conv(h1, fw["w2"], s)
    h2 = TQ._requant(acc2.reshape(-1, width), fw["a2"],
                     fw["b2"]).reshape(acc2.shape)
    return h1, h2, TQ.bottleneck_reference_q(x, fw, stride=s)


def report_codes(what, got, want):
    """The GEMM rows (pixels) whose codes differ."""
    got, want = got.flatten(0, -2).int(), want.flatten(0, -2).int()
    bad = (got != want).any(1).nonzero().flatten()
    print(f"  {what}: {int((got != want).sum())} codes differ; "
          f"{bad.numel()} of {got.shape[0]} rows off"
          + (f", first {bad[:12].tolist()}" if bad.numel() else ""),
          flush=True)
    return bad.numel() == 0


def check_s8():
    gen = torch.Generator().manual_seed(13)
    ok = True
    for B, H, cin, width, cout, s, ds in Q_CHECKS:
        fw = chip_smoke.random_q_block(gen, cin, width, cout, ds)
        x = chip_smoke.random_codes(gen, B, H, cin)
        h1, h2, out = buffers_s8(x, fw, s)
        print(f"int8 B={B} H={H} cin={cin} width={width} cout={cout} "
              f"stride={s} downsample={ds}", flush=True)
        want1, want2, want3 = plain_parts_s8(x, fw, s)
        for part, buf, want in ((1, h1, want1), (2, h2, want2),
                                (3, out, want3)):
            if part == 2:
                h1.copy_(want1)
            elif part == 3:
                h2.copy_(want2)
            run_part_s8(part, x, fw, s, h1, h2, out)
            torch.cuda.synchronize()
            ok &= report_codes(f"{PARTS[part]} ({'h1 h2 out'.split()[part - 1]})",
                               buf, want)
    return ok


def build_stage_probes():
    """Each STAGE_PROBES build of stage.cu alone, compiled in parallel
    into build/probe_conv_tile/<name>/lib.so; returns name -> library."""
    procs = {}
    for name, phases in STAGE_PROBES.items():
        src = OUT / name.replace(" ", "_")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        text = (src / "stage.cu").read_text()
        for phase in phases:
            for old, new in STAGE_PHASES[phase]:
                if text.count(old) != 1:
                    raise RuntimeError(f"probe {name}: stage.cu holds "
                                       f"{old!r} {text.count(old)} times")
                text = text.replace(old, new)
        (src / "stage.cu").write_text(text)
        procs[name] = (src, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
             "-o", str(src / "lib.so"), str(src / "stage.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"probe {name}: nvcc failed")
        lib = ctypes.CDLL(str(src / "lib.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mmb_stage.argtypes = [i32, i32, ptr, ptr] + [ptr] * 8 + [
            i32] * 7 + [ptr]
        lib.mmb_stage_plan_bytes.argtypes = [i32, i32]
        lib.mmb_stage_plan_bytes.restype = ctypes.c_longlong
        lib.mmb_cuda_error_string = _build.library().mmb_cuda_error_string
        libs[name] = lib
    return libs


def int_mm_ms(a, w):
    """torch._int_mm on a [M, K] and the fold's output-major w [N, K]."""
    wt = w.t().contiguous()
    return [chip_smoke.time_ms(lambda: torch._int_mm(a, wt), 20)
            for _ in range(2)]


def time_shapes_s8():
    gen = torch.Generator().manual_seed(14)
    B = chip_smoke.BATCH
    per_block = {}
    for name, H, cin, width, cout, s, ds in chip_smoke.Q_BLOCKS_224:
        fw = chip_smoke.random_q_block(gen, cin, width, cout, ds)
        x = chip_smoke.random_codes(gen, B, H, cin)
        h1, h2, out = buffers_s8(x, fw, s)
        run_part_s8(1, x, fw, s, h1, h2, out)
        run_part_s8(2, x, fw, s, h1, h2, out)
        Ho = TB._out_size(H, s)
        M1, M3 = B * H * H, B * Ho * Ho
        ops = {"conv1": 2 * M1 * cin * width,
               "grouped 3x3": 2 * M3 * 9 * width // 32 * width,
               "conv3": 2 * M3 * (width + (cin if ds else 0)) * cout}
        res = {}
        for part, what in PARTS.items():
            t = [chip_smoke.time_ms(
                lambda: run_part_s8(part, x, fw, s, h1, h2, out), 20)]
            if part == 1:
                res["_int_mm conv1"] = sum(int_mm_ms(
                    x.reshape(M1, cin), fw["w1"])) / 2
            elif part == 3:
                mm = int_mm_ms(h2.reshape(M3, width), fw["w3"])
                if ds:
                    xs = x[:, ::s, ::s].reshape(M3, cin)
                    mm = [a + b for a, b in zip(mm, int_mm_ms(xs, fw["wd"]))]
                res["_int_mm conv3"] = sum(mm) / 2
            else:
                w2 = fw["w2"].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                hb = h1.permute(0, 3, 1, 2).to(torch.bfloat16)
                res["cuDNN grouped 3x3"] = chip_smoke.time_ms(
                    lambda: torch.nn.functional.conv2d(
                        hb, w2, stride=s, padding=1, groups=32), 20)
            t.append(chip_smoke.time_ms(
                lambda: run_part_s8(part, x, fw, s, h1, h2, out), 20))
            res[what] = sum(t) / 2
        res["block"] = chip_smoke.time_ms(
            lambda: TB.fused_bottleneck(x, fw, stride=s), 20)
        parts = []
        for k, v in res.items():
            gemm = next((o for o in ops if k.endswith(o)), None)
            rate = (f" ({ops[gemm] / v / 1e9:.0f} TOP/s)" if gemm in ops
                    else "")
            parts.append(f"{k} {v:.4f} ms{rate}")
        print(f"K2 {name}: " + ", ".join(parts), flush=True)
        per_block[name] = res
        del x, fw, h1, h2, out
    keys = ("conv1", "grouped 3x3", "conv3", "_int_mm conv1",
            "_int_mm conv3", "cuDNN grouped 3x3")
    k3a = {k: 5 * per_block["layer3.1"][k] + per_block["layer4.0"][k]
           + 2 * per_block["layer4.1"][k] for k in keys}
    print("K2 per B=128 forward (layer3.0): " + ", ".join(
        f"{k} {per_block['layer3.0'][k]:.3f} ms" for k in keys), flush=True)
    print("K3a's blocks as K2 launches per B=128 forward (5 x layer3.1, "
          "layer4.0, 2 x layer4.1): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in k3a.items()), flush=True)

    libs = build_stage_probes()
    for name, H, cin, width, cout, strides in (
            ("layer3 tail", 14, 1024, 512, 1024, [1] * 5),
            ("layer4", 14, 1024, 1024, 2048, [2, 1, 1])):
        x, fws = chip_smoke.stage_inputs(gen, H, cin, width, cout, strides,
                                         True, B)
        band = TB._out_size(H, strides[0])
        fns = {"K3a": lambda: TS.fused_stage(x, fws, strides)}
        for probe, lib in libs.items():
            fns[probe] = (lambda lb=lib: TS._launch(x, fws, strides, band,
                                                    lb))
        times = {k: [] for k in fns}
        for _ in range(2):
            for k, fn in fns.items():
                times[k].append(chip_smoke.time_ms(fn, 10))
        print(f"K3a int8 {name}: " + ", ".join(
            f"{k} {' / '.join(f'{v:.4f}' for v in ts)} ms"
            for k, ts in times.items()), flush=True)
        del x, fws


# ------------------------------------------------------------- transport

T_CHECKS = [  # (B, H, cin, width, cout, stride, downsample)
    (2, 8, 64, 128, 256, 1, True),
    (3, 7, 256, 128, 256, 1, False),
    (2, 8, 256, 256, 512, 2, True),
    (3, 7, 512, 512, 1024, 2, True),
    (2, 5, 96, 128, 256, 1, True),    # a K tail: 96 codes, two slices
    (2, 4, 1024, 1024, 2048, 2, True),
]


def run_part_t(part, x, fw, stride, h1, h2, out):
    lib = _build.library()
    B, H, W, cin = x.shape
    width, cout = TB.block_dims(fw)
    code = lib.mmb_bottleneck_t_part(
        part, x.data_ptr(), *TB._ptrs(fw, TB._T_ORDER), h1.data_ptr(),
        h2.data_ptr(), out.data_ptr(), B, H, W, cin, width, cout, stride,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"K10a {PARTS[part]}")


def buffers_t(x, fw, stride):
    h1, h2, out = buffers(x, fw, stride)
    return h1, h2, out.to(torch.int8)


def plain_parts_t(x, fw, s):
    """K10a's plain version taken apart: h1, h2, and out from that h2."""
    bf16 = torch.bfloat16
    h1 = TB._conv1(x, fw, bf16)
    h2 = TB._grouped(h1, fw, s, bf16)
    B, Ho, Wo, width = h2.shape
    y = (h2.reshape(-1, width).float() @ fw["w3"].float()) * fw["a3"] \
        + fw["b3"]
    xs = x[:, ::s, ::s].reshape(-1, x.shape[3]).float()
    if "wd" in fw:
        identity = (xs @ fw["wd"].float()) * fw["ad"] + fw["bd"]
    else:
        identity = xs * fw["ai"]
    out = torch.round(y + identity).clamp(0, 127).to(torch.int8)
    return h1, h2, out.reshape(B, Ho, Wo, -1)


def codes_within(what, got, want):
    """int8 codes at most 1 apart, fewer than 1e-3 differing (phase 2f's
    gate); prints the count and the rows that differ by more."""
    diff = (got.int() - want.int()).abs().flatten(0, -2)
    bad = (diff > 1).any(1).nonzero().flatten()
    frac = float((diff > 0).float().mean())
    print(f"  {what}: {int((diff > 0).sum())} codes differ (max "
          f"{int(diff.max())}); {bad.numel()} of {diff.shape[0]} rows off "
          f"by more than 1" + (f", first {bad[:12].tolist()}"
                               if bad.numel() else ""), flush=True)
    return bad.numel() == 0 and frac < 1e-3


def check_t():
    gen = torch.Generator().manual_seed(15)
    ok = True
    for B, H, cin, width, cout, s, ds in T_CHECKS:
        fw = chip_smoke.random_t_block(gen, cin, width, cout, ds)
        x = chip_smoke.random_codes(gen, B, H, cin)
        h1, h2, out = buffers_t(x, fw, s)
        print(f"transport B={B} H={H} cin={cin} width={width} cout={cout} "
              f"stride={s} downsample={ds}", flush=True)
        want1, want2, want3 = plain_parts_t(x, fw, s)
        run_part_t(1, x, fw, s, h1, h2, out)
        torch.cuda.synchronize()
        ok &= report_rows("conv1 (h1)", h1, want1)
        h1.copy_(want1)
        run_part_t(2, x, fw, s, h1, h2, out)
        torch.cuda.synchronize()
        ok &= report_rows("grouped 3x3 (h2)", h2, want2)
        h2.copy_(want2)
        run_part_t(3, x, fw, s, h1, h2, out)
        torch.cuda.synchronize()
        ok &= codes_within("conv3 (out)", out, want3)
    for M, cin, cout in ((1, 64, 128), (7, 96, 256), (200, 128, 256)):
        args = epilogue_args(gen, M, cin, cout)
        ok &= report_rows(f"K11 M={M} Cin={cin} Cout={cout}",
                          TE.conv1x1_bn_residual_relu(*args),
                          TE.epilogue_reference(*args))
    return ok


def in_turns(fns, iters=20):
    """Each function's time (ms), in turns: the list, then reversed."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(chip_smoke.time_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def time_shapes_t():
    gen = torch.Generator().manual_seed(16)
    B = chip_smoke.BATCH
    t_plan = {name: count for name, *_, count in chip_smoke.T_BLOCKS_224}
    total = collections.Counter()
    for name, H, cin, width, cout, s, ds, _ in chip_smoke.BLOCKS_224:
        fw = chip_smoke.random_t_block(gen, cin, width, cout, ds)
        x = chip_smoke.random_codes(gen, B, H, cin)
        xb, fwb = chip_smoke.random_block(gen, H, cin, width, cout, s, ds, B)
        h1, h2, out = buffers_t(x, fw, s)
        k1h1, k1h2, k1out = buffers(xb, fwb, s)
        for part in (1, 2, 3):
            run_part_t(part, x, fw, s, h1, h2, out)
        Ho = TB._out_size(H, s)
        M1, M3 = B * H * H, B * Ho * Ho
        a1 = x.reshape(M1, cin).to(torch.bfloat16)
        a3, w3 = h2.reshape(M3, width), fw["w3"]
        if ds:  # the downsample as a second K segment, gathered ahead
            a3 = torch.cat([a3, x[:, ::s, ::s].reshape(M3, cin).to(
                torch.bfloat16)], 1)
            w3 = torch.cat([w3, fw["wd"]], 0)
        flops = {1: 2 * M1 * cin * width, 2: 2 * M3 * 9 * width // 32 * width,
                 3: 2 * M3 * (width + (cin if ds else 0)) * cout}
        res = {}
        for part, what in PARTS.items():
            fns = {"K10a": lambda p=part: run_part_t(p, x, fw, s, h1, h2,
                                                     out),
                   "K1": lambda p=part: run_part(p, xb, fwb, s, k1h1, k1h2,
                                                 k1out)}
            if part != 2:
                a, w = (a1, fw["w1"]) if part == 1 else (a3, w3)
                fns["matmul"] = lambda a=a, w=w: torch.matmul(a, w)
            for k, v in in_turns(fns).items():
                res[f"{what} {k}"] = v
        parts = []
        for k, v in res.items():
            part = next(p for p, w in PARTS.items() if k.startswith(w))
            parts.append(f"{k} {v:.4f} ms ({flops[part] / v / 1e9:.0f} "
                         f"TFLOP/s)")
        print(f"K10a {name}: " + ", ".join(parts), flush=True)
        if name in t_plan:
            for k, v in res.items():
                total[k] += t_plan[name] * v
        del x, fw, xb, fwb, h1, h2, out, k1h1, k1h2, k1out, a1, a3, w3
    print("K10a's blocks of the \"t\" plan per B=128 forward (layer2.0, 3 x "
          "layer2.1, layer3.0): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in total.items()), flush=True)


def epilogue_args(gen, M, cin, cout):
    """K11's inputs on the card (chip_smoke.py phase 2f's distributions)."""
    return ((torch.randn(M, cin, generator=gen).clamp_min(0)).to(
                "cuda", torch.bfloat16),
            (torch.randn(cin, cout, generator=gen) / cin ** 0.5).to(
                "cuda", torch.bfloat16),
            (0.5 + torch.rand(cout, generator=gen)).cuda(),
            (0.1 * torch.randn(cout, generator=gen)).cuda(),
            torch.randn(M, cout, generator=gen).to("cuda", torch.bfloat16))


def time_epilogue():
    gen = torch.Generator().manual_seed(17)
    B = chip_smoke.BATCH
    total = collections.Counter()
    for name, H, cin, width, cout, s, ds, count in chip_smoke.BLOCKS_224:
        Ho = TB._out_size(H, s)
        M = B * Ho * Ho
        args = epilogue_args(gen, M, width, cout)
        xb, fwb = chip_smoke.random_block(gen, H, cin, width, cout, s, ds, B)
        k1h1, k1h2, k1out = buffers(xb, fwb, s)
        x, w = args[:2]
        res = in_turns({
            "K11": lambda: TE.conv1x1_bn_residual_relu(*args),
            "matmul": lambda: torch.matmul(x, w),
            "K1 conv3": lambda: run_part(3, xb, fwb, s, k1h1, k1h2, k1out)})
        flops = 2 * M * width * cout
        k1_flops = 2 * M * (width + (cin if ds else 0)) * cout
        rates = {k: (k1_flops if k == "K1 conv3" else flops) / v / 1e9
                 for k, v in res.items()}
        print(f"K11 {name} conv3 M={M} Cin={width} Cout={cout}: " + ", ".join(
            f"{k} {v:.4f} ms ({rates[k]:.0f} TFLOP/s)" for k, v in res.items())
            + (" (K1's conv3 with the downsample's segment)" if ds else ""),
            flush=True)
        for k, v in res.items():
            total[k] += count * v
        del args, xb, fwb, k1h1, k1h2, k1out, x, w
    print("K11 over the 16 conv3 of a B=128 forward: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in total.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="hold each launch against its plain version first")
    ap.add_argument("--int8", action="store_true",
                    help="K2 and the int8 stage instead of K1")
    ap.add_argument("--transport", action="store_true",
                    help="K10a's launches and its probe builds instead")
    ap.add_argument("--epilogue", action="store_true",
                    help="K11 at every conv3 shape instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_conv_tile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    if args.transport or args.epilogue:
        if args.check and not check_t():
            print("probe_conv_tile: a K10a or K11 launch disagrees with its "
                  "plain version", file=sys.stderr)
            return 1
        if args.transport:
            time_shapes_t()
        if args.epilogue:
            time_epilogue()
        return 0
    if args.int8:
        if args.check and not check_s8():
            print("probe_conv_tile: an int8 launch disagrees with its plain "
                  "version", file=sys.stderr)
            return 1
        time_shapes_s8()
        return 0
    if args.check and not check():
        print("probe_conv_tile: a launch disagrees with its plain version",
              file=sys.stderr)
        return 1
    time_shapes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
