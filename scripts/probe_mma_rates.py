#!/usr/bin/env python3
"""The tensor-core rates the K9 and K4 redesigns choose between, measured
on the card: cycles per instruction per SM sub-partition (``clock64`` of
warp 0 of each block, 132 blocks) of

- ``mma.sync`` m16n8k8 .tf32 and m16n8k16 .bf16 (f32 sums), with 1 to 8
  independent accumulators a warp and 4 to 16 warps a block: latency shows
  where few chains run, the rate where many do;
- ``wgmma`` m64n64k8 .tf32 (A in registers, B K-major in shared memory
  without swizzle), back to back on one accumulator, one or two
  warpgroups a block;

and a check of that ``wgmma`` form's layouts against a product on the host
(A [64, 32] from registers in the m16n8k8 fragment order, warp w rows
16 w ..; B [64, 32] K-major as 8 x 4 core matrices, K-adjacent ones 128
bytes apart, 8-row groups K / 4 x 128 bytes apart; both descriptor
readings of those two offsets are tried and the one that matches is
named). The source is written into ``build/probe_mma_rates/`` (git-ignored)
and compiled with nvcc. Needs an NVIDIA H100 and the CUDA toolkit:

    python3 scripts/probe_mma_rates.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multimodal_baby_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "probe_mma_rates"
ITERS = 4096
SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int OP, int CHAINS>
__global__ void mma_rate(float* out, long long* cycles, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u + threadIdx.x + i;
  float d[CHAINS][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (OP == 0) mma_tf32(d[c], a, b); else mma_bf16(d[c], a, b);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// B [64 n][K = 32] K-major as core matrices (n / 8, k / 4) of 8 x 4,
// K-adjacent 128 bytes apart, n-adjacent 8 x 128 bytes apart
__global__ void wgmma_check(const float* A, const float* B, float* D,
                            int swap) {
  __shared__ __align__(128) float bs[64 * 32];
  for (int e = threadIdx.x; e < 64 * 32; e += blockDim.x) {
    const int n = e / 32, k = e % 32;
    bs[((n / 8) * 8 + k / 4) * 32 + (n % 8) * 4 + k % 4] = B[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float d[32] = {};
  const int lbo = swap ? 1024 : 128, sbo = swap ? 128 : 1024;
  wg_fence();
  for (int ks = 0; ks < 4; ++ks) {
    const int r = 16 * w + g, k = 8 * ks + q;
    const uint32_t a[4] = {__float_as_uint(A[r * 32 + k]),
                           __float_as_uint(A[(r + 8) * 32 + k]),
                           __float_as_uint(A[r * 32 + k + 4]),
                           __float_as_uint(A[(r + 8) * 32 + k + 4])};
    wgmma_tf32(d, a, desc(bs + 2 * ks * 32, lbo, sbo), 1);
  }
  wg_commit();
  wg_wait0();
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i)
      D[(16 * w + g + 8 * (i / 2)) * 64 + 8 * j + 2 * q + i % 2] = d[4 * j + i];
}

__global__ void wgmma_rate(float* out, long long* cycles, int iters) {
  __shared__ __align__(128) float bs[64 * 8];
  for (int e = threadIdx.x; e < 64 * 8; e += blockDim.x) bs[e] = 1.0f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u;
  float d[32] = {};
  const uint64_t db = desc(bs, 128, 256);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; it += 16) {
    wg_fence();
#pragma unroll
    for (int i = 0; i < 16; ++i) wgmma_tf32(d, a, db, 1);
    wg_commit();
    wg_wait0();
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

#define RATE(OP, C) \
  extern "C" int rate_##OP##_##C(void* o, void* c, int warps, int iters) { \
    mma_rate<OP, C><<<132, 32 * warps>>>((float*)o, (long long*)c, iters); \
    return (int)cudaDeviceSynchronize(); }
RATE(0, 1) RATE(0, 2) RATE(0, 4) RATE(0, 8)
RATE(1, 1) RATE(1, 2) RATE(1, 4) RATE(1, 8)

extern "C" int wg_rate(void* o, void* c, int wgs, int iters) {
  wgmma_rate<<<132, 128 * wgs>>>((float*)o, (long long*)c, iters);
  return (int)cudaDeviceSynchronize();
}

extern "C" int wg_check(const void* a, const void* b, void* d, int swap) {
  wgmma_check<<<1, 128>>>((const float*)a, (const float*)b, (float*)d, swap);
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mma_rates: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "rates.cu"
    src.write_text(SOURCE)
    proc = subprocess.run(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS, "-o",
         str(OUT / "rates.so"), str(src)], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(OUT / "rates.so"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = torch.zeros(132 * 512, device="cuda")
    cyc = torch.zeros(132, dtype=torch.int64, device="cuda")
    for op, name, flop in ((0, "mma.sync m16n8k8 tf32", 2048),
                           (1, "mma.sync m16n8k16 bf16", 4096)):
        for warps in (4, 8, 16):
            for chains in (1, 2, 4, 8):
                fn = getattr(lib, f"rate_{op}_{chains}")
                fn(ctypes.c_void_p(out.data_ptr()),
                   ctypes.c_void_p(cyc.data_ptr()), warps, 64)  # warm
                code = fn(ctypes.c_void_p(out.data_ptr()),
                          ctypes.c_void_p(cyc.data_ptr()), warps, ITERS)
                assert code == 0, code
                c = float(cyc.double().mean())
                per_sp = c / (ITERS * chains * warps / 4)
                print(f"{name}: {warps:2d} warps x {chains} chains: "
                      f"{per_sp:6.2f} cycles an mma per sub-partition, "
                      f"{4 * flop / per_sp:7.1f} FLOP/cycle/SM", flush=True)
    for wgs in (1, 2):
        lib.wg_rate(ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(cyc.data_ptr()), wgs, 64)
        code = lib.wg_rate(ctypes.c_void_p(out.data_ptr()),
                           ctypes.c_void_p(cyc.data_ptr()), wgs, ITERS)
        assert code == 0, code
        per = float(cyc.double().mean()) / ITERS / wgs
        print(f"wgmma m64n64k8 tf32, {wgs} warpgroup(s): {per:6.2f} cycles "
              f"a wgmma per SM, {65536 / per:7.1f} FLOP/cycle/SM", flush=True)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 32, generator=gen)
    b = torch.randn(64, 32, generator=gen)
    want = (a.double() @ b.double().T)
    ac, bc = a.cuda(), b.cuda()
    for swap in (0, 1):
        d = torch.zeros(64, 64, device="cuda")
        code = lib.wg_check(ctypes.c_void_p(ac.data_ptr()),
                            ctypes.c_void_p(bc.data_ptr()),
                            ctypes.c_void_p(d.data_ptr()), swap)
        err = float((d.cpu().double() - want).abs().max())
        label = "LBO 1024, SBO 128" if swap else "LBO 128, SBO 1024"
        print(f"wgmma tf32 layout check, {label}: exit {code}, max abs err "
              f"{err:.3g} (TF32 truncation: ~1e-2 expected if right)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
