// The tiled GEMMs shared by the port's kernels (sm_90a): C = A . B with
// A [M, K] and B [K, N] row-major, and an epilogue functor that turns each
// row's 8 consecutive sums into the output.
//
//   bf16: f32 accumulation; 128x128x32 tiles, 8 warps (4 along M x 2 along
//         N), wmma 16x16x16 on mma.sync, a two-stage cp.async pipeline.
//   int8: exact int32 accumulation; 128x128x64 tiles on the same warp grid,
//         mma.sync m16n8k32 (the shape the tensor cores' int8 rate is
//         quoted for). B is output-major, [N, K]; shared memory holds both
//         operands as 16-byte K chunks ([chunk][row][16]).
//
// Rows past M are masked; N must be a multiple of 128 and K of the K tile.
// B is [K, N] (bf16) or [N, K] (int8).
// K may come in two segments: the second reads its A rows from an NHWC
// tensor [*, H, W, k2] at (ho * stride, wo * stride) (the bottleneck
// block's strided downsample). The bf16 GEMM sums both segments into one
// accumulator, or keeps them apart in its SPLIT mode; the int8 GEMM keeps
// one per segment (their scales differ). A bf16 GEMM's segment may read
// int8 A rows (the int8-transport blocks' input codes).
//
// The M rows may be a band of image rows: `rows` maps row m to rows
// [lo, lo + ext) of every image of a [*, H, W] pixel grid (ext = 0: every
// row, M = pixels in order). Segment-1 A rows and the output use the map.
//
// The epilogue is a functor called once for each row m < M and each
// 8-column group starting at n, with the output pixel p = map(m):
//   bf16: __device__ void operator()(int p, int n, float (&v)[8]) const
//   int8: __device__ void operator()(int p, int n, const int (&v)[8],
//                                    const int (&vd)[8]) const
// (vd: the downsample segment's sums; v again when there is none).
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
constexpr int BK = 32;        // bf16 K tile (64 bytes a row)
constexpr int BK8 = 64;       // int8 K tile (64 bytes a row)
constexpr int A_LD = BK + 8;  // bf16 shared-memory pitch in elements; the
constexpr int B_LD = BN + 8;  // skew keeps wmma loads off one bank
constexpr int GEMM_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int GEMM_SMEM =          // bf16: A, B stages and per-warp scratch
    (2 * BM * A_LD + 2 * BK * B_LD) * 2 + (GEMM_THREADS / 32) * 256 * 4;
constexpr int GEMM_HELD_SMEM =     // bf16 with a held first segment
    GEMM_SMEM + BM * BN * 4;
constexpr int GEMM8_SMEM =         // int8
    2 * BM * BK8 + 2 * BK8 * BN + (GEMM_THREADS / 32) * 256 * 4;

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

template <class T>
struct GemmArgsT {
  // dense A rows [M, k1] (through `rows`) and B [k1, N] (int8: [N, k1])
  const T* a1;
  const T* b1;
  int k1;
  // optional second K segment: A rows gathered from an NHWC tensor
  // [*, H, W, k2] at (ho * stride, wo * stride) of the output grid `rows`,
  // B [k2, N] (int8: [N, k2]); k2 = 0 when absent
  const T* a2;
  const T* b2;
  int k2;
  int H, W, stride;
  RowMap rows;
  int M, N;
};
using GemmArgs = GemmArgsT<__nv_bfloat16>;
using GemmArgsS8 = GemmArgsT<int8_t>;

// GEMM row m -> input pixel of the second segment
template <class T>
__device__ __forceinline__ int gather_row(const GemmArgsT<T>& g, int m) {
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

// int8 requantisation, as the TPU kernels' epilogue
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

// ------------------------------------------------------------------ int8

// D += A . B for one 16x8 output tile and 32 of K, int8 in, int32 sums:
// a holds the thread's four 4-byte pieces of the 16x32 A tile (rows g and
// g + 8, columns 4t.. and 16 + 4t..), b its two of the 32x8 B tile (rows
// 4t.. and 16 + 4t.. of column g), d rows g and g + 8, columns 2t, 2t + 1
// (g = lane / 4, t = lane % 4; PTX's m16n8k32 fragments)
__device__ __forceinline__ void mma_s8_16x8x32(int (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B here is output-major, [N, K] (each output column's K bytes contiguous:
// the `col` operand of m16n8k32). Shared memory holds A as [chunk][BM][16]
// and B as [chunk][BN][16] (16-byte K chunks), so a fragment's 4-byte
// pieces are 8 rows x 16 bytes apart: no bank conflicts.
template <bool TWO, class Epilogue>
__device__ __forceinline__ void gemm_s8_tile(const GemmArgsS8& g,
                                             const Epilogue& epi, int m0,
                                             int n0, unsigned char* smem) {
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [2][BK8/16][BM][16]
  int8_t* Bs = As + 2 * BM * BK8;                // [2][BK8/16][BN][16]
  int* scratch = reinterpret_cast<int*>(Bs + 2 * BK8 * BN);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;   // 32-row slab
  const int wn = warp >> 2;  // 64-column slab
  const int gq = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;   // 4-byte piece within it

  // A: BM rows x 4 chunks = 512 vectors of 16 bytes, two per thread; the
  // same for B's BN rows (output columns)
  const int8_t* src1[2];
  const int8_t* src2[2];
  const int8_t* bsrc1[2];
  const int8_t* bsrc2[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * GEMM_THREADS;
    const int m = m0 + (v >> 2);
    const int col = (v & 3) * 16;
    ok[i] = m < g.M;
    src1[i] = ok[i] ? g.a1 + static_cast<size_t>(map_row(g.rows, m)) * g.k1 +
                          col
                    : g.a1;
    src2[i] = ok[i] && TWO
                  ? g.a2 + static_cast<size_t>(gather_row(g, m)) * g.k2 + col
                  : g.a1;
    bsrc1[i] = g.b1 + static_cast<size_t>(n0 + (v >> 2)) * g.k1 + col;
    bsrc2[i] = TWO ? g.b2 + static_cast<size_t>(n0 + (v >> 2)) * g.k2 + col
                   : g.b1;
  }

  auto load_tile = [&](int kt, int stage) {
    const int kbase = kt * BK8;
    const bool second = kbase >= g.k1;
    int8_t* as = As + stage * BM * BK8;
    int8_t* bs = Bs + stage * BK8 * BN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GEMM_THREADS;
      const int8_t* src =
          !ok[i] ? g.a1 : second ? src2[i] + (kbase - g.k1) : src1[i] + kbase;
      cp_async16(as + ((v & 3) * BM + (v >> 2)) * 16, src, ok[i]);
      const int8_t* bsrc =
          second ? bsrc2[i] + (kbase - g.k1) : bsrc1[i] + kbase;
      cp_async16(bs + ((v & 3) * BN + (v >> 2)) * 16, bsrc, true);
    }
  };

  int acc[2][8][4];
  int accd[TWO ? 2 : 1][TWO ? 8 : 1][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if constexpr (TWO) accd[i][j][e] = 0;
      }

  const int ktiles = (g.k1 + (TWO ? g.k2 : 0)) / BK8;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* as = As + (kt & 1) * BM * BK8;
    const int8_t* bs = Bs + (kt & 1) * BK8 * BN;
    const bool second = kt * BK8 >= g.k1;
#pragma unroll
    for (int ks = 0; ks < BK8 / 32; ++ks) {  // chunks 2 ks and 2 ks + 1
      const int8_t* a_lo = as + (2 * ks * BM) * 16 + tq * 4;
      const int8_t* a_hi = a_lo + BM * 16;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + gq;
        af[i][0] = *reinterpret_cast<const uint32_t*>(a_lo + r * 16);
        af[i][1] = *reinterpret_cast<const uint32_t*>(a_lo + (r + 8) * 16);
        af[i][2] = *reinterpret_cast<const uint32_t*>(a_hi + r * 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(a_hi + (r + 8) * 16);
      }
      const int8_t* b_lo = bs + (2 * ks * BN) * 16 + tq * 4;
      const int8_t* b_hi = b_lo + BN * 16;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = wn * 64 + j * 8 + gq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b_lo + c * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b_hi + c * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (TWO) {
            if (second) {
              mma_s8_16x8x32(accd[i][j], af[i], b0, b1);
              continue;
            }
          }
          mma_s8_16x8x32(acc[i][j], af[i], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: each 16x16 block (two 16x8 tiles) goes through a per-warp
  // scratch tile; a lane then owns 8 consecutive columns of one row
  int* sc = scratch + warp * 256;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
  auto stage_block = [&](const int (&t0)[4], const int (&t1)[4],
                         int (&v)[8]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int(&t)[4] = h ? t1 : t0;
      sc[gq * 16 + h * 8 + tq * 2] = t[0];
      sc[gq * 16 + h * 8 + tq * 2 + 1] = t[1];
      sc[(gq + 8) * 16 + h * 8 + tq * 2] = t[2];
      sc[(gq + 8) * 16 + h * 8 + tq * 2 + 1] = t[3];
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sc[r * 16 + c0 + e];
    __syncwarp();
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + jj * 16 + c0;
      int v[8], vd[8];
      stage_block(acc[i][2 * jj], acc[i][2 * jj + 1], v);
      if constexpr (TWO) {
        stage_block(accd[i][2 * jj], accd[i][2 * jj + 1], vd);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) vd[e] = v[e];
      }
      if (m < g.M) epi(map_row(g.rows, m), n, v, vd);
    }
  }
}

template <bool TWO, class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_s8(const GemmArgsS8 g, const Epilogue epi) {
  __shared__ __align__(128) unsigned char smem[GEMM8_SMEM];
  gemm_s8_tile<TWO>(g, epi, blockIdx.y * BM, blockIdx.x * BN, smem);
}

template <class Epilogue>
cudaError_t launch_gemm_s8(const GemmArgsS8& g, const Epilogue& epi,
                           cudaStream_t stream) {
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  if (g.k2)
    gemm_s8<true, Epilogue><<<grid, GEMM_THREADS, 0, stream>>>(g, epi);
  else
    gemm_s8<false, Epilogue><<<grid, GEMM_THREADS, 0, stream>>>(g, epi);
  return cudaGetLastError();
}

}  // namespace
