#!/usr/bin/env python3
"""The pieces of K5 (``fused_block_attention``, csrc/vit_attention.cu)
timed alone at the ViT-B/14 shapes of a B = 128 forward (M = B N = 32,896
token rows, C = 768, F = 3072, 12 heads of 64):

- the wgmma Dense tile (csrc/vit_gemm.cuh) at the four ViT GEMM shapes,
  qkv [M, 768] . [768, 2304], proj [M, 768] . [768, 768], fc1 [M, 768] .
  [768, 3072] and fc2 [M, 3072] . [3072, 768], each with its block's
  epilogue (RoundThenBias, ResidualBias, BiasGelu, ResidualBias), beside
  one ``torch.matmul`` of the same product (cuBLAS, bf16 out), in TFLOP/s;
  each checked first against the f32 product (max error relative to the
  largest output);
- K5's deferred attention alone on the qkv tensor (the column slices, row
  stride 3C), beside ``scaled_dot_product_attention`` on the same q, k, v;
- K5 whole, beside the sum of its qkv, attention and proj pieces (the
  rest is its LayerNorm launch);
- K7 (``fused_vit_block``, csrc/vit_block.cu) taken apart: the kernel
  beside probe builds of the same source with its attention phase
  (``no_attention``) or its two LayerNorm phases (``no_layernorm``)
  removed; each build's ptxas registers and spills, and K5 then K6
  beside them. The probes compute garbage and are only timed; each is
  vit_block.cu compiled alone with nvcc into ``build/probe_vit/``
  (git-ignored), the builds in parallel.

Times are CUDA-event means over 20 launches (10 for K7's), taken in turns
(kernel, library, library, kernel). Needs an NVIDIA H100 and the CUDA
toolkit:

    python3 scripts/probe_vit.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multimodal_baby_tpu_torch.ops import _build  # noqa: E402
from multimodal_baby_tpu_torch.ops.attention import (  # noqa: E402
    attention_geometry, fused_block_attention)
from multimodal_baby_tpu_torch.ops.vit_mlp import fused_mlp  # noqa: E402

B, N, C, F_, HEADS = 128, 257, 768, 3072, 12
M = B * N
SCALE = 64 ** -0.5
ITERS = 20
# (name, K, N, epilogue code: 0 RoundThenBias, 1 ResidualBias, 2 BiasGelu)
DENSES = [("qkv", C, 3 * C, 0), ("proj", C, C, 1), ("fc1", C, F_, 2),
          ("fc2", F_, C, 1)]
OUT = ROOT / "build" / "probe_vit"
ATTENTION = "  attention_phase<SINGLE>(p, smem);\n"
LAYERNORM = ("  layer_norm_phase(p.x, p.g1, p.gb1, p.xn, M, C, p.eps);\n",
             "  layer_norm_phase(p.y, p.g2, p.gb2, p.xn, M, C, p.eps);\n")
# K7 probe -> the lines of vit_block.cu it removes
K7_PROBES = {"kernel": (), "no_attention": (ATTENTION,),
             "no_layernorm": LAYERNORM}


def time_ms(fn, iters: int = ITERS) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, library):
    k1, l1 = time_ms(kernel), time_ms(library)
    l2, k2 = time_ms(library), time_ms(kernel)
    return (k1 + k2) / 2, (l1 + l2) / 2


def build_k7(name: str, cut) -> subprocess.Popen:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    text = (src / "vit_block.cu").read_text()
    for line in cut:
        if line not in text:
            raise RuntimeError(f"probe {name}: the source no longer holds "
                               f"{line!r}")
        text = text.replace(line, "")
    (src / "vit_block.cu").write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS, "-o",
         str(src / "lib.so"), str(src / "vit_block.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def k7_apart(rnd, stream) -> None:
    """K7 and its probe builds at B = 128, N = 257, beside K5 then K6."""
    procs = {name: build_k7(name, cut) for name, cut in K7_PROBES.items()}
    libs = {}
    for name, proc in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode:
            print("\n".join(lines[-40:]), file=sys.stderr)
            raise RuntimeError(f"probe {name}: nvcc failed")
        for i, line in enumerate(lines):
            if ("Function properties for" in line
                    and "vit_block_kernelILb1" in line):
                print(f"  K7 {name} (one pass): "
                      f"{lines[i + 2].split(': ', 1)[-1]}; "
                      f"{lines[i + 1].strip()}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.mmb_vit_block_bf16.argtypes = (
            [ctypes.c_void_p] * 20 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        libs[name] = lib
    x = rnd(B, N, C)
    params = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 3 * C, sc=C ** -0.5),
              rnd(3 * C, sc=0.1), rnd(C, C, sc=C ** -0.5), rnd(C, sc=0.1),
              1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, F_, sc=C ** -0.5),
              rnd(F_, sc=0.1), rnd(F_, C, sc=F_ ** -0.5), rnd(C, sc=0.1)]
    scratch = [torch.empty(B, N, w, dtype=torch.bfloat16, device="cuda")
               for w in (C, 3 * C, C, C, F_, C)]
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    geo = attention_geometry(N)

    def k7(lib):
        _build.check(lib, lib.mmb_vit_block_bf16(
            *(t.data_ptr() for t in [x, *params, *scratch, bar]), B, N, C,
            F_, N, 0, SCALE, 1e-6, geo.np, geo.kc, geo.nchunks, geo.rows,
            stream), "K7 probe")

    runs = {name: (lambda lib=lib: k7(lib)) for name, lib in libs.items()}
    runs["K5 then K6"] = lambda: fused_mlp(fused_block_attention(
        x, *params[:6], HEADS, SCALE), *params[6:])
    times = {name: [] for name in runs}
    with torch.no_grad():
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name].append(time_ms(runs[name], 10))
    for name, ts in times.items():
        print(f"  K7 {name}: {sum(ts) / 2:.4f} ms a call "
              f"({' / '.join(f'{t:.4f}' for t in ts)})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_vit: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"probe_vit: {card}; B={B} N={N} C={C} F={F_}", flush=True)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g) * sc).to("cuda",
                                                          torch.bfloat16)

    pieces = {}
    for name, K, Nc, epi in DENSES:
        a, w = rnd(M, K), rnd(K, Nc, sc=K ** -0.5)
        bias, res = rnd(Nc, sc=0.1), rnd(M, Nc)
        out = torch.empty(M, Nc, dtype=torch.bfloat16, device="cuda")

        def dense():
            _build.check(lib, lib.mmb_vit_dense_bf16(
                a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
                out.data_ptr(), M, K, Nc, epi, 0, stream), name)

        dense()
        exact = a.float() @ w.float()
        want = {0: exact.bfloat16().float() + bias.float(),
                1: res.float() + exact + bias.float(),
                2: F.gelu(exact + bias.float())}[epi]
        rel = float((out.float() - want).abs().max() / want.abs().max())
        ms, lib_ms = in_turns(dense, lambda: torch.matmul(a, w))
        tflop = 2 * M * K * Nc / 1e12
        pieces[name] = ms
        print(f"  {name:5s} [{M}x{K}].[{K}x{Nc}]: tile {ms:.4f} ms "
              f"({tflop / ms * 1e3:.1f} TFLOP/s), torch.matmul {lib_ms:.4f} "
              f"ms ({tflop / lib_ms * 1e3:.1f} TFLOP/s); rel err {rel:.2e}",
              flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"{name}: rel err {rel:.2e}")

    qkv = rnd(B, N, 3 * C, sc=0.35)
    y = torch.empty(B, N, C, dtype=torch.bfloat16, device="cuda")
    geo = attention_geometry(N)

    def attention():
        _build.check(lib, lib.mmb_vit_attention_core_bf16(
            qkv.data_ptr(), y.data_ptr(), B, N, C, N, SCALE, *geo, stream),
            "attention")

    def heads(t):
        return t.reshape(B, N, HEADS, 64).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(C, -1))
    ms, lib_ms = in_turns(attention,
                          lambda: F.scaled_dot_product_attention(q, k, v))
    pieces["attention"] = ms
    print(f"  attention (deferred, geometry {tuple(geo)}): {ms:.4f} ms, "
          f"SDPA {lib_ms:.4f} ms", flush=True)

    x = rnd(B, N, C)
    params = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 3 * C, sc=C ** -0.5),
              rnd(3 * C, sc=0.1), rnd(C, C, sc=C ** -0.5), rnd(C, sc=0.1)]
    with torch.no_grad():
        whole = time_ms(lambda: fused_block_attention(x, *params, HEADS,
                                                      SCALE))
    parts = pieces["qkv"] + pieces["attention"] + pieces["proj"]
    print(f"  K5 whole {whole:.4f} ms a call ({whole * 12:.3f} per forward);"
          f" qkv + attention + proj {parts:.4f}, the rest (LayerNorm) "
          f"{whole - parts:.4f}", flush=True)
    k7_apart(rnd, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
