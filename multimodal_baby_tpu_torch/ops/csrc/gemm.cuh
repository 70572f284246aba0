// The tiled bf16 GEMM shared by the port's wmma kernels (sm_90a: K9, K10a,
// K11): C = A . B with A [M, K] and B [K, N] row-major, and an epilogue
// functor that turns each row's 8 consecutive sums into the output. f32
// accumulation; 128x128x32 tiles, 8 warps (4 along M x 2 along N), wmma
// 16x16x16 on mma.sync, a two-stage cp.async pipeline. (The int8 blocks
// run conv_gemm_s8.cuh's wgmma tile.)
//
// Rows past M are masked; N must be a multiple of 128 and K of the K tile.
// K may come in two segments: the second reads its A rows from an NHWC
// tensor [*, H, W, k2] at (ho * stride, wo * stride) (the bottleneck
// block's strided downsample). The GEMM sums both segments into one
// accumulator, or keeps them apart in its SPLIT mode. A segment may read
// int8 A rows (the int8-transport blocks' input codes).
//
// The M rows may be a band of image rows: `rows` maps row m to rows
// [lo, lo + ext) of every image of a [*, H, W] pixel grid (ext = 0: every
// row, M = pixels in order). Segment-1 A rows and the output use the map.
//
// The epilogue is a functor called once for each row m < M and each
// 8-column group starting at n, with the output pixel p = map(m):
//   __device__ void operator()(int p, int n, float (&v)[8]) const
// (SPLIT: operator()(p, n, v, vd), vd the second segment's sums).
//
// Each GEMM is a __device__ tile routine (one BM x BN output tile, shared
// memory passed in) wrapped by a __global__ kernel with one tile per
// block; the persistent stage kernel (stage.cu) calls the tile routines
// in a loop.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;        // K tile (64 bytes a row)
constexpr int A_LD = BK + 8;  // bf16 shared-memory pitch in elements; the
constexpr int B_LD = BN + 8;  // skew keeps wmma loads off one bank
constexpr int GEMM_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int GEMM_SMEM =          // bf16: A, B stages and per-warp scratch
    (2 * BM * A_LD + 2 * BK * B_LD) * 2 + (GEMM_THREADS / 32) * 256 * 4;
constexpr int GEMM_HELD_SMEM =     // bf16 with a held first segment
    GEMM_SMEM + BM * BN * 4;

// Rows [lo, lo + ext) of every image of a [*, H, W] pixel grid; ext = 0
// means all H rows.
struct RowMap {
  int H, W, lo, ext;
};

// GEMM row m -> pixel index in the grid
__device__ __forceinline__ int map_row(const RowMap& r, int m) {
  if (r.ext == 0) return m;
  const int per = r.ext * r.W;
  const int b = m / per;
  return (b * r.H + r.lo) * r.W + (m - b * per);
}

struct GemmArgs {
  // dense A rows [M, k1] (through `rows`) and B [k1, N]
  const __nv_bfloat16* a1;
  const __nv_bfloat16* b1;
  int k1;
  // optional second K segment: A rows gathered from an NHWC tensor
  // [*, H, W, k2] at (ho * stride, wo * stride) of the output grid `rows`,
  // B [k2, N]; k2 = 0 when absent
  const __nv_bfloat16* a2;
  const __nv_bfloat16* b2;
  int k2;
  int H, W, stride;
  RowMap rows;
  int M, N;
};

// GEMM row m -> input pixel of the second segment
__device__ __forceinline__ int gather_row(const GemmArgs& g, int m) {
  const RowMap& r = g.rows;
  const int per = (r.ext ? r.ext : r.H) * r.W;
  const int b = m / per;
  const int rem = m - b * per;
  const int ho = rem / r.W;
  const int wo = rem - ho * r.W;
  return (b * g.H + (r.lo + ho) * g.stride) * g.W + wo * g.stride;
}

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

// int8 requantisation (K10a's, K2's and the grouped 3x3's epilogues), as
// the TPU kernels' epilogue
// clip(round(acc * a + b), 0, 127): the product and the sum each rounded
// once (no fused multiply-add), round half to even
__device__ __forceinline__ float madd_rn(float acc, float a, float b) {
  return __fadd_rn(__fmul_rn(acc, a), b);
}

__device__ __forceinline__ int8_t clip_code(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), 0.0f), 127.0f));
}

// 8 int8 codes (8 bytes) <-> 8 floats
__device__ __forceinline__ void unpack8_s8(const uint2 raw, float (&f)[8]) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = static_cast<float>(p[e]);
}

__device__ __forceinline__ uint2 pack8_s8(const int8_t (&c)[8]) {
  uint2 raw;
  int8_t* p = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = c[e];
  return raw;
}

// ------------------------------------------------------------------ bf16

// Q1 / Q2: that K segment's A rows are int8 codes (the int8-transport
// blocks' input), read into registers a tile ahead, converted to bf16 (exact:
// |code| <= 127) and stored to shared memory after the current tile's
// products; g.a1 / g.a2 then point at int8. SPLIT: the second segment gets
// its own sums: at the segment boundary each warp parks the first segment's
// sums in shared memory (GEMM_HELD_SMEM in all) and the epilogue is called
// as epi(p, n, v, vd) with v the first segment's sums, vd the second's.
template <bool Q1 = false, bool Q2 = false, bool SPLIT = false,
          class Epilogue>
__device__ __forceinline__ void gemm_bf16_tile(const GemmArgs& g,
                                               const Epilogue& epi, int m0,
                                               int n0, unsigned char* smem) {
  using namespace nvcuda;
  constexpr bool ANY_Q = Q1 || Q2;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * BM * A_LD;
  float* scratch = reinterpret_cast<float*>(Bs + 2 * BK * B_LD);
  float* held = reinterpret_cast<float*>(smem + GEMM_SMEM);  // [BM][BN]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;   // 32-row slab
  const int wn = warp >> 2;  // 64-column slab

  // the two A rows this thread loads at every K step: their sources
  // (bf16 segments), or their int8 sources (Q segments)
  const __nv_bfloat16* src1[2];
  const __nv_bfloat16* src2[2];
  const int8_t* qsrc1[2];
  const int8_t* qsrc2[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ((tid + i * GEMM_THREADS) >> 2);
    const int col = ((tid + i * GEMM_THREADS) & 3) * 8;
    ok[i] = m < g.M;
    const size_t off1 =
        ok[i] ? static_cast<size_t>(map_row(g.rows, m)) * g.k1 + col : 0;
    const size_t off2 =
        ok[i] && g.k2 ? static_cast<size_t>(gather_row(g, m)) * g.k2 + col
                      : 0;
    // masked rows keep a valid address and read nothing
    if constexpr (Q1)
      qsrc1[i] = reinterpret_cast<const int8_t*>(g.a1) + off1;
    else
      src1[i] = g.a1 + off1;
    if constexpr (Q2)
      qsrc2[i] = reinterpret_cast<const int8_t*>(g.a2) + off2;
    else
      src2[i] = ok[i] && g.k2 ? g.a2 + off2 : g.a1;
  }
  const auto quant = [&](int kt) {  // is tile kt's A int8?
    return kt * BK >= g.k1 ? Q2 : Q1;
  };
  uint2 qreg[2];  // int8 A vectors of the next tile
  const auto fetch_q = [&](int kt) {
    const int kbase = kt * BK;
    const bool second = kbase >= g.k1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* src =
          second ? qsrc2[i] + (kbase - g.k1) : qsrc1[i] + kbase;
      // L2, not L1: in the stage kernel another block wrote it
      qreg[i] = ok[i] ? __ldcg(reinterpret_cast<const uint2*>(src))
                      : make_uint2(0u, 0u);
    }
  };
  const auto store_q = [&](int stage) {
    __nv_bfloat16* as = As + stage * BM * A_LD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GEMM_THREADS;
      float f[8];
      unpack8_s8(qreg[i], f);
      *reinterpret_cast<uint4*>(as + (v >> 2) * A_LD + (v & 3) * 8) =
          pack8(f);
    }
  };

  auto load_tile = [&](int kt, int stage, bool a_too) {
    const int kbase = kt * BK;
    const bool second = kbase >= g.k1;
    __nv_bfloat16* as = As + stage * BM * A_LD;
    __nv_bfloat16* bs = Bs + stage * BK * B_LD;
    // A: BM rows x BK columns = 512 vectors of 8 bf16, two per thread
    if (a_too) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + i * GEMM_THREADS;
        const __nv_bfloat16* src =
            !ok[i] ? g.a1 : second ? src2[i] + (kbase - g.k1) : src1[i] + kbase;
        cp_async16(as + (v >> 2) * A_LD + (v & 3) * 8, src, ok[i]);
      }
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
      cp_async16(bs + row * B_LD + col, src, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (g.k1 + g.k2) / BK;
  if (ANY_Q && quant(0)) {
    load_tile(0, 0, false);
    fetch_q(0);
    store_q(0);
  } else {
    load_tile(0, 0, true);
  }
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const bool next_q = ANY_Q && kt + 1 < ktiles && quant(kt + 1);
    if (kt + 1 < ktiles) {
      load_tile(kt + 1, (kt + 1) & 1, !next_q);
      if (next_q) fetch_q(kt + 1);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* as = As + (kt & 1) * BM * A_LD;
    const __nv_bfloat16* bs = Bs + (kt & 1) * BK * B_LD;
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
    // the stage written here was last read in iteration kt - 1, before its
    // closing barrier
    if (next_q) store_q((kt + 1) & 1);
    if constexpr (SPLIT) {
      if ((kt + 1) * BK == g.k1) {  // the first segment is complete
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(
                held + (wm * 32 + i * 16) * BN + wn * 64 + j * 16,
                acc[i][j], BN, wmma::mem_row_major);
            wmma::fill_fragment(acc[i][j], 0.0f);
          }
      }
    }
    __syncthreads();  // the next iteration overwrites this stage
  }

  // epilogue: each 16x16 accumulator goes through a per-warp f32 scratch
  // tile; a lane then owns 8 consecutive columns of one row
  float* sc = scratch + warp * 256;
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
        if constexpr (SPLIT) {
          const float* h =
              held + (wm * 32 + i * 16 + r) * BN + wn * 64 + j * 16 + c0;
          float v1[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v1[e] = h[e];
          epi(map_row(g.rows, m), n, v1, v);
        } else {
          epi(map_row(g.rows, m), n, v);
        }
      }
      __syncwarp();
    }
  }
}

template <class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_bf16(const GemmArgs g, const Epilogue epi) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  gemm_bf16_tile(g, epi, blockIdx.y * BM, blockIdx.x * BN, smem);
}

template <class Epilogue>
cudaError_t launch_gemm(const GemmArgs& g, const Epilogue& epi,
                        cudaStream_t stream) {
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_bf16<Epilogue><<<grid, GEMM_THREADS, 0, stream>>>(g, epi);
  return cudaGetLastError();
}

// the same with int8 A segments and / or the split second segment, in
// dynamic shared memory (the held sums take it past the 48 KB static limit)
template <bool Q1, bool Q2, bool SPLIT, class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_bf16_x(const GemmArgs g, const Epilogue epi) {
  // (named apart from the other kernels' dynamic shared arrays, which
  // some sources declare with another element type)
  extern __shared__ __align__(128) unsigned char gemm_x_smem[];
  gemm_bf16_tile<Q1, Q2, SPLIT>(g, epi, blockIdx.y * BM, blockIdx.x * BN,
                                gemm_x_smem);
}

template <bool Q1, bool Q2, bool SPLIT, class Epilogue>
cudaError_t launch_gemm_x(const GemmArgs& g, const Epilogue& epi,
                          cudaStream_t stream) {
  constexpr int smem = SPLIT ? GEMM_HELD_SMEM : GEMM_SMEM;
  const auto kernel = gemm_bf16_x<Q1, Q2, SPLIT, Epilogue>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  kernel<<<grid, GEMM_THREADS, smem, stream>>>(g, epi);
  return cudaGetLastError();
}

}  // namespace
