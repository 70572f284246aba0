// The tiled bf16 GEMM shared by the port's kernels (sm_90a): C = A . B with
// A [M, K] and B [K, N] row-major bf16, f32 accumulation, and an epilogue
// functor that turns each row's 8 consecutive f32 sums into the output.
//
// 128x128x32 tiles, 8 warps (4 along M x 2 along N), wmma 16x16x16 on
// mma.sync, a two-stage cp.async pipeline. Rows past M are masked; N must
// be a multiple of 128 and K a multiple of 32. K may come in two segments:
// the second reads its A rows from an NHWC tensor [*, H, W, k2] at
// (ho * stride, wo * stride) (the bottleneck block's strided downsample).
//
// The epilogue is a functor with
//   __device__ void operator()(int m, int n, float (&v)[8]) const
// called once for each row m < M and each 8-column group starting at n.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int A_LD = BK + 8;  // shared-memory pitch in elements; the skew
constexpr int B_LD = BN + 8;  // keeps wmma loads off one bank
constexpr int GEMM_THREADS = 256;  // 8 warps: 4 along M x 2 along N

struct GemmArgs {
  // dense A rows [M, k1] and B [k1, N]
  const __nv_bfloat16* a1;
  const __nv_bfloat16* b1;
  int k1;
  // optional second K segment: A rows gathered from an NHWC tensor
  // [*, H, W, k2] at (ho * stride, wo * stride), B [k2, N]; k2 = 0 when absent
  const __nv_bfloat16* a2;
  const __nv_bfloat16* b2;
  int k2;
  int H, W, Ho, Wo, stride;
  int M, N;
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

__device__ __forceinline__ void load_tile(const GemmArgs& g, int kt, int m0,
                                          int n0, __nv_bfloat16* As,
                                          __nv_bfloat16* Bs) {
  const int tid = threadIdx.x;
  const int kbase = kt * BK;
  const bool second = kbase >= g.k1;
  // A: BM rows x BK columns = 512 vectors of 8 bf16, two per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * GEMM_THREADS;
    const int row = v >> 2;
    const int col = (v & 3) * 8;
    const int m = m0 + row;
    const bool ok = m < g.M;
    const __nv_bfloat16* src = g.a1;  // a valid address for masked rows
    if (ok) {
      if (!second) {
        src = g.a1 + static_cast<size_t>(m) * g.k1 + kbase + col;
      } else {
        const int hw = g.Ho * g.Wo;
        const int b = m / hw;
        const int r = m - b * hw;
        const int ho = r / g.Wo;
        const int wo = r - ho * g.Wo;
        const size_t pix =
            (static_cast<size_t>(b) * g.H + static_cast<size_t>(ho) * g.stride) *
                g.W +
            static_cast<size_t>(wo) * g.stride;
        src = g.a2 + pix * g.k2 + (kbase - g.k1) + col;
      }
    }
    cp_async16(As + row * A_LD + col, src, ok);
  }
  // B: BK rows x BN columns = 512 vectors, two per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * GEMM_THREADS;
    const int row = v >> 4;
    const int col = (v & 15) * 8;
    const __nv_bfloat16* src =
        second ? g.b2 + static_cast<size_t>(kbase - g.k1 + row) * g.N + n0 + col
               : g.b1 + static_cast<size_t>(kbase + row) * g.N + n0 + col;
    cp_async16(Bs + row * B_LD + col, src, true);
  }
}

template <class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_bf16(const GemmArgs g, const Epilogue epi) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * B_LD];
  __shared__ __align__(128) float scratch[GEMM_THREADS / 32][16 * 16];

  using namespace nvcuda;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;   // 32-row slab
  const int wn = warp >> 2;  // 64-column slab

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (g.k1 + g.k2) / BK;
  load_tile(g, 0, m0, n0, As[0], Bs[0]);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles)
      load_tile(g, kt + 1, m0, n0, As[(kt + 1) & 1], Bs[(kt + 1) & 1]);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * B_LD + wn * 64 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration overwrites this stage
  }

  // epilogue: each 16x16 accumulator goes through a per-warp f32 scratch
  // tile; a lane then owns 8 consecutive columns of one row
  float* sc = scratch[warp];
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c0;
      if (m < g.M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = sc[r * 16 + c0 + e];
        epi(m, n, v);
      }
      __syncwarp();
    }
  }
}

template <class Epilogue>
cudaError_t launch_gemm(const GemmArgs& g, const Epilogue& epi,
                        cudaStream_t stream) {
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_bf16<Epilogue><<<grid, GEMM_THREADS, 0, stream>>>(g, epi);
  return cudaGetLastError();
}

}  // namespace
