// The ViT's Dense GEMM on Hopper's warpgroup product (wgmma, sm_90a) fed
// by the Tensor Memory Accelerator (TMA), shared by K5 (vit_attention.cu:
// qkv, proj) and K7 (vit_block.cu: qkv, proj, fc1, fc2): out =
// epilogue(A . W), A [M, K] bf16 row-major (rows >= M read as zeros and
// not stored: M = B N is ragged), W [K, N] bf16 row-major (N % 128 == 0, K
// % 64 == 0), f32 sums, and one of vit.cuh's epilogue functors
// (RoundThenBias, ResidualBias, BiasGelu), called once per row and 8
// consecutive columns.
//
// Bits. Every output's sum runs over K in k16 steps in order, each step's
// 16 products summed by the tensor core and added to the f32 accumulator,
// as the port's earlier wmma tile summed them: the outputs equal that
// tile's bit for bit (as K10b's wgmma equals K1's), and K6's
// ping-pong tile (vit_pingpong.cuh) sums in the same order, which keeps K7
// equal to K5 then K6.
//
// Design. Two consumer warpgroups (threads 0-255) and a producer. An
// output tile is 256 rows x 128 columns; warpgroup wg takes rows 128 wg ..
// + 127 as two m64n128k16 products a k16 step (128 f32 accumulators a
// thread). A block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// (row band outer, columns inner), and the 64-deep K slices of all its
// tiles stream through a four-stage ring as one sequence, filled with TMA
// copies (the A slice [256][64], K-major with the 128-byte swizzle, and
// the W slice as two [64][64] MN-major atoms with the 128-byte swizzle:
// 48 KB a stage), each stage guarded by a "full" mbarrier (the copies'
// bytes) and an "empty" one (the consumers' arrivals once their products
// of it are done), so the copies run ahead with no block barrier. The
// producer is either a ninth warp, one thread of which issues every copy
// (vit_gemm_produce: K5's kernel, 288 threads; the copies run up to four
// slices ahead and the consumers issue none), or warpgroup 0 itself, its
// thread 0 issuing between its own products (the PRODUCE form of
// vit_gemm_consume: K7, 256 threads, so that its attention phase gets 255
// registers a thread; three slices ahead). A consumer keeps one wgmma group in
// flight. The epilogue takes the accumulators straight from registers: a
// 4 x 4 transpose of f32 pairs within each quad of lanes gives a lane 8
// consecutive columns of one row, which the functor takes. Shared memory:
// four stages and 1 KB to align the swizzle atoms, 197,632 bytes, one
// block per SM; the mbarriers are static shared memory. The slice counter
// runs on across calls in one launch (K7's four Dense phases), so the
// barriers' phases need no reset. Role branches test a warp-uniform
// warpgroup index and the in-loop producer's copies are predicated in
// PTX: a thread-divergent branch on the consumers' path makes ptxas
// serialize their wgmma.
//
// What bounds it on an H100: tensor-core throughput at the ViT-B shapes
// (qkv at B = 128: 116 GFLOP, 0.118 ms at 989 TFLOP/s, on 205 MB in and
// out, 0.061 ms at 3.35 TB/s). Per slice a block reads 48 KB from L2 for
// 4.2 MFLOP (11.4 bytes a kFLOP: ~6.9 TB/s from L2 at 600 TFLOP/s).

#pragma once

#include <cuda.h>

#include "vit.cuh"
#include "wgmma.cuh"

namespace {

constexpr int VG_CONSUMERS = 256;  // two warpgroups
constexpr int VG_THREADS = VG_CONSUMERS + 32;  // and the producer warp
constexpr int VG_BM = 256;       // rows of a tile: 128 a warpgroup
constexpr int VG_BN = 128;       // columns of a tile
constexpr int VG_BK = 64;        // depth of a ring slice: 128 bytes a row
constexpr int VG_STAGES = 4;
constexpr int VG_A_ELEMS = VG_BM * VG_BK;   // an A slice [256][64]
constexpr int VG_ATOM_ELEMS = VG_BK * 64;   // a W atom [64][64]
constexpr int VG_STAGE_ELEMS = VG_A_ELEMS + 2 * VG_ATOM_ELEMS;
constexpr int VG_STAGE_BYTES = VG_STAGE_ELEMS * 2;
constexpr int VG_ALIGN = 1024;   // the swizzle atoms' alignment
constexpr int VG_SMEM = VG_STAGES * VG_STAGE_BYTES + VG_ALIGN;

// one Dense: out = epi(a . w), a [M, K], w [K, N], with their TMA maps
// (vit_dense)
struct VitDense {
  CUtensorMap a_map;  // boxes of 256 rows x 64 columns
  CUtensorMap w_map;  // boxes of 64 rows x 64 columns
  int M, K, N;
};

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to
// the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// a TMA map of a row-major bf16 [rows, cols] tensor in boxes of box_rows x
// 64 columns (128 bytes: the 128-byte swizzle), rows past the end read as
// zeros
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows,
                            int cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the Dense a [M, K] . w [K, N] with its TMA maps
inline cudaError_t vit_dense(VitDense* d, const void* a, const void* w,
                             int M, int K, int N) {
  d->M = M;
  d->K = K;
  d->N = N;
  const cudaError_t err = bf16_map(&d->a_map, a, M, K, VG_BM);
  return err != cudaSuccess ? err : bf16_map(&d->w_map, w, K, N, VG_BK);
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (the loop in PTX,
// as a branch ptxas sees as uniform)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the warpgroup of this thread, broadcast from lane 0 so that the compiler
// knows it is the same across the warp: a role branch on it is not a
// divergent path, in which ptxas would serialize the wgmma
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// mbar_expect and tma_load by the threads with p set, the predicate in
// PTX, so that a warpgroup calling them keeps one path
__device__ __forceinline__ void mbar_expect_if(bool p, uint64_t* bar,
                                               int bytes) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes), "r"(static_cast<int>(p))
      : "memory");
}

__device__ __forceinline__ void tma_load_if(bool p, void* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c, int r) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %5, 0;\n"
      "@q cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(r), "r"(static_cast<int>(p))
      : "memory");
}

// the box at (column c, row r) of the map into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(r)
      : "memory");
}

// ------------------------------------------------------------ the tile

// the 1024-byte aligned start of a dynamic shared-memory block (the
// launch adds VG_ALIGN bytes of slack)
__device__ __forceinline__ unsigned char* align_atoms(unsigned char* p) {
  return p + ((VG_ALIGN - (smem_addr(p) & (VG_ALIGN - 1))) & (VG_ALIGN - 1));
}

// lane q of each quad gets, from its quad, the 8 columns of n8 tile 4 jg +
// q of the rows it holds: w[k] is this lane's pair of tile 4 jg + k; the
// result in v, columns in order
__device__ __forceinline__ void quad_transpose(const float2 (&w)[4],
                                               float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // lane q takes from lane (q + r) % 4 its pair of tile 4 jg + q, which
    // that lane sends as w[(its q - r) % 4]
    const int is = (q - r) & 3;
    const float2 send = is == 0 ? w[0] : is == 1 ? w[1] : is == 2 ? w[2]
                                                                  : w[3];
    const int src = (lane & ~3) | ((q + r) & 3);
    const float gx = __shfl_sync(0xffffffffu, send.x, src);
    const float gy = __shfl_sync(0xffffffffu, send.y, src);
    const int ig = (q + r) & 3;  // the pair's place among the 8 columns
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = ig == k ? gx : v[2 * k];
      v[2 * k + 1] = ig == k ? gy : v[2 * k + 1];
    }
  }
}

// the ring's mbarriers: full (the producer's arrival and the copies'
// bytes) and empty (every consumer thread's arrival)
struct VitRing {
  uint64_t full[VG_STAGES];
  uint64_t empty[VG_STAGES];
};

// by one thread, before any tile walk in the launch (whose block barrier
// publishes it)
__device__ __forceinline__ void vit_ring_init(VitRing& r) {
#pragma unroll
  for (int s = 0; s < VG_STAGES; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], VG_CONSUMERS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The ring's ends: every thread of the block, before and after each tile
// walk. Shared memory written by the generic proxy before it (another
// phase) is overwritten by the copies only after it, and the copies'
// writes are done before generic use after it.
__device__ __forceinline__ void ring_boundary() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// the slices of d that this block's tiles (blockIdx.x, + gridDim.x, ...)
// take
__device__ __forceinline__ int walk_steps(const VitDense& d) {
  const int tiles = (d.N / VG_BN) * ((d.M + VG_BM - 1) / VG_BM);
  const int mine = static_cast<int>(blockIdx.x) < tiles
                       ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  return mine * (d.K / VG_BK);
}

// The producer's part of the tile walk of d (one thread; d in kernel
// parameter space, where TMA reads its maps): every slice of the block's
// tiles into the ring, slice counter from q.
__device__ __forceinline__ void vit_gemm_produce(const VitDense& d,
                                                 __nv_bfloat16* stages,
                                                 VitRing& ring, int q) {
  const int nt = d.N / VG_BN;
  const int nk = d.K / VG_BK;
  const int steps = walk_steps(d);
  int t = blockIdx.x, kt = 0;
  for (int i = 0; i < steps; ++i) {
    const int s = (q + i) % VG_STAGES;
    mbar_wait(&ring.empty[s], (((q + i) / VG_STAGES) & 1) ^ 1);
    mbar_expect(&ring.full[s], VG_STAGE_BYTES);
    __nv_bfloat16* st = stages + s * VG_STAGE_ELEMS;
    const int n0 = (t % nt) * VG_BN;
    tma_load(st, &d.a_map, &ring.full[s], kt * VG_BK, (t / nt) * VG_BM);
    tma_load(st + VG_A_ELEMS, &d.w_map, &ring.full[s], n0, kt * VG_BK);
    tma_load(st + VG_A_ELEMS + VG_ATOM_ELEMS, &d.w_map, &ring.full[s],
             n0 + 64, kt * VG_BK);
    if (++kt == nk) {
      kt = 0;
      t += gridDim.x;
    }
  }
}

// The consumers' part of the tile walk of d (threads 0 .. VG_CONSUMERS -
// 1): the products of every slice as it lands, each tile's epilogue, the
// stages released; slice counter from q. PRODUCE: there is no producer
// warp, and warpgroup 0 fills the ring VG_STAGES - 1 slices ahead, each
// stage once every consumer has released it (after its own products of
// the step).
template <bool PRODUCE = false, class Epilogue>
__device__ __forceinline__ void vit_gemm_consume(const VitDense& d,
                                                 const Epilogue& epi,
                                                 __nv_bfloat16* stages,
                                                 VitRing& ring, int q) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warpgroup();
  const int g8 = lane >> 2;
  const int nt = d.N / VG_BN;
  const int nk = d.K / VG_BK;
  const int steps = walk_steps(d);
  float acc[2][64];
  // PRODUCE: thread 0 issues (predicated in PTX)
  const bool issuer = threadIdx.x == 0;
  int pt = blockIdx.x, pk = 0;
  const auto produce = [&](int j) {
    const int s = (q + j) % VG_STAGES;
    mbar_wait(&ring.empty[s], (((q + j) / VG_STAGES) & 1) ^ 1);
    mbar_expect_if(issuer, &ring.full[s], VG_STAGE_BYTES);
    __nv_bfloat16* st = stages + s * VG_STAGE_ELEMS;
    const int n0 = (pt % nt) * VG_BN;
    tma_load_if(issuer, st, &d.a_map, &ring.full[s], pk * VG_BK,
                (pt / nt) * VG_BM);
    tma_load_if(issuer, st + VG_A_ELEMS, &d.w_map, &ring.full[s], n0,
                pk * VG_BK);
    tma_load_if(issuer, st + VG_A_ELEMS + VG_ATOM_ELEMS, &d.w_map,
                &ring.full[s], n0 + 64, pk * VG_BK);
    if (++pk == nk) {
      pk = 0;
      pt += gridDim.x;
    }
  };
  if (PRODUCE && wg == 0)
    for (int j = 0; j < VG_STAGES - 1 && j < steps; ++j) produce(j);
  int t = blockIdx.x, kt = 0;
  for (int i = 0; i < steps; ++i) {
    const int s = (q + i) % VG_STAGES;
    mbar_wait(&ring.full[s], ((q + i) / VG_STAGES) & 1);
    const __nv_bfloat16* st = stages + s * VG_STAGE_ELEMS;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < VG_BK / 16; ++kk) {
      // W: LBO one atom (8 KB), SBO 8 rows x 128 bytes; k16 step kk is 16
      // rows down
      const uint64_t db = wg_desc(st + VG_A_ELEMS + 16 * kk * 64,
                                  VG_ATOM_ELEMS * 2, 1024, 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A: rows 128 wg + 64 h ..; SBO 8 rows x 128 bytes; k16 step kk is
        // 32 bytes into the rows
        const uint64_t da = wg_desc(
            st + (128 * wg + 64 * h) * VG_BK + 16 * kk, 16, 1024, 1);
        wgmma_128(acc[h], da, db, kt > 0 || kk > 0);
      }
    }
    wg_commit();
    wg_wait<1>();  // the products of the previous slice are done
    if (kt > 0) mbar_arrive(&ring.empty[(q + i - 1) % VG_STAGES]);
    if (PRODUCE && wg == 0 && i + VG_STAGES - 1 < steps)
      produce(i + VG_STAGES - 1);
    if (kt == nk - 1) {
      wg_wait<0>();
      mbar_arrive(&ring.empty[s]);
      // the epilogue: rows 128 wg + 64 h + 16 (warp % 4) + g8 (+ 8)
      const int n0 = (t % nt) * VG_BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int m = (t / nt) * VG_BM + 128 * wg + 64 * h +
                        16 * (warp & 3) + g8 + 8 * rh;
#pragma unroll
          for (int jg = 0; jg < 4; ++jg) {
            float2 w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int tt = 4 * jg + k;
              w[k] = make_float2(acc[h][4 * tt + 2 * rh],
                                 acc[h][4 * tt + 2 * rh + 1]);
            }
            float v[8];
            quad_transpose(w, v);
            if (m < d.M) epi(m, n0 + 8 * (4 * jg + (lane & 3)), v);
          }
        }
      }
    }
    if (++kt == nk) {
      kt = 0;
      t += gridDim.x;
    }
  }
}

// BiasGelu with its GELU form fixed at compile time (the functor's own
// arithmetic; the form's branches fold away, so the 8 columns of a call
// interleave)
template <int MODE>
struct BiasGeluForm {
  BiasGelu e;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    BiasGelu f = e;
    f.mode = MODE;
    f(m, n, v);
  }
};

// K5's Dense: one tile walk, warpgroups 0 and 1 consuming, thread
// VG_CONSUMERS (the ninth warp) producing
template <class Epilogue>
__global__ void __launch_bounds__(VG_THREADS, 1)
    vit_gemm(const __grid_constant__ VitDense d, const Epilogue epi) {
  extern __shared__ __align__(128) unsigned char vit_gemm_smem[];
  __shared__ VitRing ring;
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(align_atoms(vit_gemm_smem));
  if (threadIdx.x == 0) vit_ring_init(ring);
  ring_boundary();
  if (warpgroup() < 2)
    vit_gemm_consume(d, epi, stages, ring, 0);
  else if (threadIdx.x == VG_CONSUMERS)
    vit_gemm_produce(d, stages, ring, 0);
}

// a [M, K] . w [K, N] on one block per SM (at most one per tile), each
// walking its tiles
template <class Epilogue>
cudaError_t launch_vit_gemm(const void* a, const void* w, int M, int K,
                            int N, const Epilogue& epi, cudaStream_t stream) {
  VitDense d;
  cudaError_t err = vit_dense(&d, a, w, M, K, N);
  if (err != cudaSuccess) return err;
  const auto kernel = vit_gemm<Epilogue>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VG_SMEM);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (N / VG_BN) * ((M + VG_BM - 1) / VG_BM);
  kernel<<<tiles < sms ? tiles : sms, VG_THREADS, VG_SMEM, stream>>>(d, epi);
  return cudaGetLastError();
}

}  // namespace
