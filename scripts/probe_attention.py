#!/usr/bin/env python3
"""Where K8c's time goes (``fused_qkv_attention_pairs``, csrc/attention.cu):
the kernel timed at the ViT-B/14 shape of the train step (B = 128, N = 257,
C = 768, 12 heads) beside probe builds of the same source with one part
taken out, and K8a (``fused_attention``) beside it:

- ``no_w``: the projection ring copies no W slices;
- ``no_x``: it copies no x slices;
- ``no_copies``: neither (the ring's barriers, fences and wgmma remain);
- ``no_attention``: phase 2 projects Q but runs no attention.

A probe computes garbage and is only timed; the kernel as built is first
checked against its plain version. Each probe is ``attention.cu`` compiled
alone with nvcc into ``build/probe_attention/`` (git-ignored), the builds
in parallel; the times are taken in turns (all, then all again). Needs an
NVIDIA H100 and the CUDA toolkit:

    python3 scripts/probe_attention.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multimodal_baby_tpu_torch.ops import _build  # noqa: E402
from multimodal_baby_tpu_torch.ops.attention import (  # noqa: E402
    attention_geometry, attention_reference, qkv_attention_pairs_reference)

B, N, C, HEADS = 128, 257, 768, 12
SCALE = 64 ** -0.5
OUT = ROOT / "build" / "probe_attention"
W_COPY = "    cp_async16(ws + sww(k, c), a.w + (k0 + k) * ldw + wc, true);"
X_COPY = ("    const bool ok = r0 + r < a.N;\n"
          "    cp_async16(stage + swx(r, ch * 8),")
ATTENTION = ("      attention_slab<false, SINGLE>(qa, Ks, Vs, gm, kv_valid, c, "
             "false, o);")
# probe -> [(text in attention.cu, its replacement)]
PROBES = {
    "kernel": [],
    "no_w": [(W_COPY, W_COPY.replace("    cp_async16", "    if (a.N < 0) "
                                     "cp_async16"))],
    "no_x": [(X_COPY, X_COPY.replace("    cp_async16", "    if (a.N < 0) "
                                     "cp_async16"))],
    "no_attention": [(ATTENTION, "      for (int j = 0; j < 8; ++j)\n"
                      "        for (int e = 0; e < 4; ++e)\n"
                      "          o[j][e] = __uint_as_float(qa[j & 3][e]);")],
}
PROBES["no_copies"] = PROBES["no_w"] + PROBES["no_x"]


def build(name: str, edits) -> subprocess.Popen:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    text = (src / "attention.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"probe {name}: the source no longer holds "
                               f"{old!r}")
        text = text.replace(old, new)
    (src / "attention.cu").write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS, "-o",
         str(src / "lib.so"), str(src / "attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.mmb_attention_f32p_bf16.argtypes = (
        [ptr] * 4 + [i64] * 4 + [i32] * 8 + [f32] + [i32] * 6 + [ptr])
    lib.mmb_qkv_attention_bf16.argtypes = (
        [ptr] * 4 + [i32] * 4 + [f32] + [i32] * 6 + [ptr])
    return lib


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_attention: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    procs = {name: build(name, edits) for name, edits in PROBES.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"probe {name}: nvcc failed")
        libs[name] = load(name)

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g) * sc).to("cuda",
                                                          torch.bfloat16)

    x, w, b = rnd(B, N, C), rnd(C, 3 * C, sc=C ** -0.5), rnd(3 * C, sc=0.1)
    q, k, v = (rnd(B * HEADS, N, 64) for _ in range(3))
    y, yh = torch.empty_like(x), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    geo_c, geo_a = attention_geometry(N, qkv=True), attention_geometry(N)

    def k8c(lib):
        return lib.mmb_qkv_attention_bf16(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, N, C,
            N, SCALE, *geo_c, stream)

    def k8a(lib):
        return lib.mmb_attention_f32p_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), yh.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), yh.stride(0), 64, 64, 64,
            64, B * HEADS, 1, N, N, SCALE, *geo_a, stream)

    lib = libs["kernel"]
    if k8c(lib) or k8a(lib):
        raise RuntimeError("probe_attention: launch failed")
    torch.cuda.synchronize()
    for what, got, want in (
            ("K8c", y, qkv_attention_pairs_reference(x, w, b, HEADS, SCALE)),
            ("K8a", yh, attention_reference(q, k, v, SCALE))):
        rel = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        print(f"{what} against its plain version: rel {rel:.3e}")
        if rel > 1e-2:
            raise AssertionError(f"{what}: rel {rel:.3e} > 1e-2")
    print(card)
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append((time_ms(lambda: k8c(lib)),
                                time_ms(lambda: k8a(lib))))
    for name, ts in times.items():
        print(f"{name:13s} K8c {' / '.join(f'{c:.4f}' for c, _ in ts)} ms"
              f"   K8a {' / '.join(f'{a:.4f}' for _, a in ts)} ms "
              f"(B={B}, N={N}, per call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
