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
  (git-ignored), the builds in parallel;
- K6's two Denses (fc1 with bias and the erf GELU, fc2 with the residual
  sum) on its ping-pong tile (csrc/vit_pingpong.cuh), beside K5's tile
  (csrc/vit_gemm.cuh; fc1 and fc2 with BiasGelu and ResidualBias) and
  ``torch.matmul``. The two tiles must give the same bits (each sums k16
  steps in order into one f32 accumulator). Beside them, probe builds
  that drop fc1's GELU or the epilogue's arithmetic (``K6_PROBES``), and
  block 0's timeline of a launch (a build that stores clock64 at each
  tile's events), which take the tile's time apart; then K6 whole beside
  the sum of its pieces.

Times are CUDA-event means over 20 launches (10 for K7's), taken in turns
(kernel, library, library, kernel; the K6 Denses in the order listed,
then back). Needs an NVIDIA H100 and the CUDA toolkit:

    python3 scripts/probe_vit.py        # everything
    python3 scripts/probe_vit.py --k6   # K6's Denses and K6 only
"""

from __future__ import annotations

import argparse
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
from multimodal_baby_tpu_torch.ops.vit_mlp import (  # noqa: E402
    fused_mlp, mlp_geometry)

B, N, C, F_, HEADS = 128, 257, 768, 3072, 12
M = B * N
SCALE = 64 ** -0.5
ITERS = 20
# (name, K, N, epilogue code: 0 RoundThenBias, 1 ResidualBias, 2 BiasGelu)
DENSES = [("qkv", C, 3 * C, 0), ("proj", C, C, 1), ("fc1", C, F_, 2),
          ("fc2", F_, C, 1)]
# K6's Denses: (name, K, N, epilogue code: 1 ResidualBias, 2 BiasGelu)
K6_DENSES = [("fc1", C, F_, 2), ("fc2", F_, C, 1)]
OUT = ROOT / "build" / "probe_vit"
ATTENTION = "  attention_phase<SINGLE>(p, smem);\n"
LAYERNORM = ("  layer_norm_phase(p.x, p.g1, p.gb1, p.xn, M, C, p.eps);\n",
             "  layer_norm_phase(p.y, p.g2, p.gb2, p.xn, M, C, p.eps);\n")
# K7 probe -> the lines of vit_block.cu it removes
K7_PROBES = {"kernel": (), "no_attention": (ATTENTION,),
             "no_layernorm": LAYERNORM}
# K6 probe builds of vit.cu: name -> {file: [(text, its replacement)]}.
# They compute garbage and are only timed: without fc1's GELU (the bias
# added), without any epilogue arithmetic (the accumulators staged and
# stored as they are). (The ordering barriers cannot go: they also keep the
# warpgroups' ring slices in order.)
GELU_RETURN = "return pack2(gelu(a0 + b.x, MODE), gelu(a1 + b.y, MODE));"
RESIDUAL_RETURN = "return pack2((rf.x + a0) + b.x, (rf.y + a1) + b.y);"
K6_PROBES = {
    "no GELU": {"vit_pingpong.cuh": [(
        GELU_RETURN, "return pack2(a0 + b.x, a1 + b.y);")]},
    "no arithmetic": {"vit_pingpong.cuh": [
        (GELU_RETURN, "return pack2(a0, a1);"),
        (RESIDUAL_RETURN, "return pack2(a0, a1 + 0.0f * rf.x);")]},
}
# The timeline probe: the kernel itself with block 0's clock (clock64)
# stored at each tile j's events, slot 8 j + e: e = 0 the warpgroup's turn
# begins, 1 the ordering barrier passed, 2 its products issued, 3 its
# epilogue begins, 4 and 5 the store of its first and second half issued
# (timeline() reads 2 to 5); at each slice i
# the producer issues (2048 + i) and each slice its consumer finds full
# (5120 + i); read back through mmb_pp_trace
TRACE_HELPER = r"""
__device__ unsigned long long pp_trace[8192];
__device__ __forceinline__ void pp_mark(int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  const int p = blockIdx.x == 0 && threadIdx.x % 128 == 0 && slot < 8192;
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n"
               "@q st.global.u64 [%0], %1;\n}\n" :: "l"(pp_trace + slot),
               "l"(t), "r"(p) : "memory");
}

"""
TRACE = {
    "vit_pingpong.cuh": [
        ("// ------------------------------------------------------------ "
         "the walk\n", TRACE_HELPER),
        ("    if (j > 0) named_sync(1 + wg, 2 * PP_WG);\n",
         "    pp_mark(8 * j);\n    if (j > 0) named_sync(1 + wg, 2 * PP_WG);"
         "\n    pp_mark(8 * j + 1);\n"),
        ("    if (j + 1 < w.tiles) named_arrive(",
         "    pp_mark(8 * j + 2);\n    if (j + 1 < w.tiles) named_arrive("),
        ("    // the epilogue, a 64-row half",
         "    pp_mark(8 * j + 3);\n    // the epilogue, a 64-row half"),
        ("      bulk_commit();\n    }\n  }\n",
         "      bulk_commit();\n      pp_mark(8 * j + 4 + h);\n    }\n  }\n"),
        ("      mbar_expect(&ring.full[s], PP_STAGE_BYTES);\n",
         "      pp_mark(2048 + i);\n"
         "      mbar_expect(&ring.full[s], PP_STAGE_BYTES);\n"),
        ("      mbar_wait(&ring.full[s], (i / PP_STAGES) & 1);\n",
         "      mbar_wait(&ring.full[s], (i / PP_STAGES) & 1);\n"
         "      pp_mark(5120 + i);\n")],
    "vit.cu": [("// One of K6's Denses alone", "extern \"C\" int mmb_pp_trace("
                "void* dst, int n) {\n  return static_cast<int>("
                "cudaMemcpyFromSymbol(dst, pp_trace, n * 8));\n}\n\n"
                "// One of K6's Denses alone")]}


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


def build_probe(name: str, source: str, patches=None) -> subprocess.Popen:
    """``source`` of a copy of csrc/ whose files carry ``patches`` ({file:
    [(text, replacement)]}), compiled alone into
    build/probe_vit/<name>/lib.so."""
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for file, subs in (patches or {}).items():
        text = (src / file).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"probe {name}: {file} no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        (src / file).write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
         "-o", str(src / "lib.so"), str(src / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_probe(name: str, proc: subprocess.Popen, kernel: str,
                 label: str):
    """Wait for the probe build ``name``, print ptxas's lines of the
    kernels whose name holds ``kernel`` under ``label``, and load the
    library."""
    lines = proc.communicate()[0].splitlines()
    if proc.returncode:
        print("\n".join(lines[-40:]), file=sys.stderr)
        raise RuntimeError(f"probe {name}: nvcc failed")
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            print(f"  {label} ({line.split('for ')[-1][-40:]}): "
                  f"{lines[i + 2].split(': ', 1)[-1]}; "
                  f"{lines[i + 1].strip()}", flush=True)
        elif "wgmma" in line and "arning" in line:
            print(f"  {label}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(OUT / name / "lib.so"))


def k7_apart(rnd, stream) -> None:
    """K7 and its probe builds at B = 128, N = 257, beside K5 then K6."""
    procs = {name: build_probe(name, "vit_block.cu", {
        "vit_block.cu": [(line, "") for line in cut]})
        for name, cut in K7_PROBES.items()}
    libs = {}
    for name, proc in procs.items():
        lib = finish_probe(name, proc, "vit_block_kernelILb1", f"K7 {name}")
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


def k6_builds():
    """Start the K6 probe builds (K6_PROBES and the timeline), in
    parallel."""
    return {name: build_probe("k6_" + name.replace(" ", "_"), "vit.cu",
                              patches)
            for name, patches in {**K6_PROBES, "timeline": TRACE}.items()}


def timeline(lb, name: str, d) -> None:
    """Block 0's timeline of the last launch of the timeline probe on the
    Dense whose geometry is d, in clock cycles, over the steady tiles (the
    first and last two left out): the period (one tile's products issued
    to the next's: one tile's products when the ordering holds), the
    epilogue from its start to each half's store issued, and per slice the
    cycles from the producer's copy to the consumer finding it full. (ptxas
    may read the clock before an ordering barrier is passed, so no span
    starts at one.)"""
    tr = (ctypes.c_ulonglong * 8192)()
    _build.check(lb, lb.mmb_pp_trace(tr, 8192), "timeline")
    tiles = -(-d.tiles // d.grid)
    nk = (C if name == "fc1" else F_) // 64
    steady = range(2, tiles - 2)

    def ev(j, e):
        return tr[8 * j + e]

    def mean(xs):
        xs = list(xs)
        return sum(xs) / max(len(xs), 1)

    period = mean(ev(j + 1, 2) - ev(j, 2) for j in steady)
    first = mean(ev(j, 4) - ev(j, 3) for j in steady)
    second = mean(ev(j, 5) - ev(j, 3) for j in steady)
    lead = mean(tr[5120 + i] - tr[2048 + i]
                for i in range(2 * nk, (tiles - 2) * nk))
    print(f"  K6 {name} timeline, block 0, {tiles} tiles, cycles: tile "
          f"period {period:.0f}; epilogue to the first half's store "
          f"{first:.0f}, to the second's {second:.0f}; copy to full "
          f"{lead:.0f} a slice", flush=True)


def k6_denses(lib, builds, rnd, stream) -> None:
    """fc1 and fc2 on K6's ping-pong tile, on the probe builds, on K5's
    tile and by torch.matmul; then K6 whole."""
    probes = {}
    for name, proc in builds.items():
        lb = finish_probe("k6_" + name.replace(" ", "_"), proc,
                          "12vit_pingpongI", f"K6 {name}")
        lb.mmb_vit_mlp_dense_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        probes[name] = lb
    probes["timeline"].mmb_pp_trace.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int]
    geo = mlp_geometry(M, C, F_, torch.cuda.get_device_properties(
        0).multi_processor_count)
    pieces = {}
    for name, K, Nc, epi in K6_DENSES:
        a, w = rnd(M, K), rnd(K, Nc, sc=K ** -0.5)
        bias, res = rnd(Nc, sc=0.1), rnd(M, Nc)
        tiles = ("ping-pong", "K5's tile")
        outs = {k: torch.empty(M, Nc, dtype=torch.bfloat16, device="cuda")
                for k in tiles}
        garbage = torch.empty(M, Nc, dtype=torch.bfloat16, device="cuda")

        d = geo.fc1 if name == "fc1" else geo.fc2

        def pingpong(lb, out):
            def run():
                _build.check(lb, lb.mmb_vit_mlp_dense_bf16(
                    a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    res.data_ptr() if epi == 1 else 0, out.data_ptr(), M, K,
                    Nc, epi, 0, d.grid, stream), name)
            return run

        def k5_tile():
            _build.check(lib, lib.mmb_vit_dense_bf16(
                a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
                outs[tiles[1]].data_ptr(), M, K, Nc, epi, 0, stream), name)

        runs = {tiles[0]: pingpong(lib, outs[tiles[0]]),
                **{f"ping-pong, {k}": pingpong(lb, garbage)
                   for k, lb in probes.items()},
                tiles[1]: k5_tile, "torch.matmul": lambda: torch.matmul(a, w)}
        for tile in tiles:
            runs[tile]()
        torch.cuda.synchronize()
        exact = a.float() @ w.float()
        want = (F.gelu(exact + bias.float()) if epi == 2
                else res.float() + exact + bias.float())
        for tile, out in outs.items():
            rel = float((out.float() - want).abs().max() / want.abs().max())
            diff = int((out.view(torch.int16)
                        != outs[tiles[1]].view(torch.int16)).sum())
            print(f"  K6 {name} on {tile}: rel err {rel:.2e}, {diff} bf16 "
                  f"words differ from K5's tile", flush=True)
            if not rel <= 1e-2 or diff:
                raise AssertionError(f"K6 {name} on {tile}: rel {rel:.2e}, "
                                     f"{diff} words differ")
        times = {k: [] for k in runs}
        with torch.no_grad():
            for order in (list(runs), list(runs)[::-1]):
                for k in order:
                    times[k].append(time_ms(runs[k]))
        tflop = 2 * M * K * Nc / 1e12
        for k, ts in times.items():
            ms = sum(ts) / 2
            print(f"  K6 {name} [{M}x{K}].[{K}x{Nc}] {k}: {ms:.4f} ms "
                  f"({tflop / ms * 1e3:.1f} TFLOP/s; "
                  f"{' / '.join(f'{t:.4f}' for t in ts)})", flush=True)
        pieces[name] = sum(times[tiles[0]]) / 2
        timeline(probes["timeline"], name, d)
    x = rnd(B, N, C)
    params = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, F_, sc=C ** -0.5),
              rnd(F_, sc=0.1), rnd(F_, C, sc=F_ ** -0.5), rnd(C, sc=0.1)]
    with torch.no_grad():
        whole = time_ms(lambda: fused_mlp(x, *params))
    parts = pieces["fc1"] + pieces["fc2"]
    print(f"  K6 whole {whole:.4f} ms a call ({whole * 12:.3f} per forward);"
          f" fc1 + fc2 {parts:.4f}, the rest (LayerNorm) {whole - parts:.4f}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k6", action="store_true",
                    help="time K6's Denses and K6 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_vit: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"probe_vit: {card}; B={B} N={N} C={C} F={F_}", flush=True)
    builds = k6_builds()
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g) * sc).to("cuda",
                                                          torch.bfloat16)

    k6_denses(lib, builds, rnd, stream)
    if args.k6:
        return 0
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
