// Small pieces shared by the port's CUDA kernels (sm_90a): the row map of
// a band of image rows, cp.async copies, bf16 vectors <-> floats, and the
// int8 requantisation's rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// Rows [lo, lo + ext) of every image of a [*, H, W] pixel grid; ext = 0
// means all H rows.
struct RowMap {
  int H, W, lo, ext;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 (16 bytes) <-> 8 floats. raw is taken by value: a reference to
// device memory would read it as four 4-byte loads instead of one 16-byte one
__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(p[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return raw;
}

// int8 requantisation (K2's, K10a's and the grouped 3x3's epilogues), as
// the TPU kernels' epilogue
// clip(round(acc * a + b), 0, 127): the product and the sum each rounded
// once (no fused multiply-add), round half to even
__device__ __forceinline__ float madd_rn(float acc, float a, float b) {
  return __fadd_rn(__fmul_rn(acc, a), b);
}

__device__ __forceinline__ int8_t clip_code(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), 0.0f), 127.0f));
}

}  // namespace
