// K6's Dense GEMMs (vit.cu: fc1 and fc2) on Hopper (sm_90a): a ping-pong
// warp-specialized wgmma tile fed by TMA, out = epilogue(A . W), A [M, K]
// bf16 row-major (rows >= M read as zeros and not stored), W [K, N] bf16
// row-major (N % 128 == 0, K % 64 == 0), f32 sums, and a pair epilogue
// (PingPongGelu for fc1, PingPongResidual for fc2: vit.cuh's BiasGelu and
// ResidualBias arithmetic on two columns). It reuses vit_gemm.cuh's TMA
// maps, mbarriers and descriptors; vit_gemm.cuh's own tile (K5, K7) is
// untouched.
//
// Bits. Every output's sum runs over K in k16 steps in order into one f32
// accumulator, as vit_gemm.cuh's tile and the earlier wmma tile sum them,
// and the epilogue's arithmetic is the functors': K6's outputs equal K7's
// fc1 and fc2 phases bit for bit, so K7 still equals K5 then K6.
//
// Schedule. The block is two consumer warpgroups and a producer
// warpgroup (384 threads), one thread of which issues every copy;
// setmaxnreg gives a consumer thread 232 registers and a producer thread
// 40 (at 168, fc1's erf epilogue spilled).
// Each consumer warpgroup owns a whole 128 x 128 output tile at a time
// (two m64n128k16 products a k16 step, 128 f32 accumulators a thread), and
// the two take the block's tiles in turns: warpgroup 0 tiles 0, 2, 4, ...,
// warpgroup 1 tiles 1, 3, 5, .... An ordering barrier pair (named barriers
// 1 and 2) lets a warpgroup issue its products of a tile only once the
// other has issued all of its previous tile's; it then runs its epilogue
// while the other's products run, so the tensor cores do not idle through
// fc1's GELU or fc2's residual. The barriers also keep the ring's slices
// in the order the producer fills them. The K slices of the block's tiles
// stream through a six-stage ring of 32 KB (the A slice [128][64], K-major
// with the 128-byte swizzle; the W slice as two [64][64] MN-major atoms
// with the 128-byte swizzle), each stage guarded by a "full" mbarrier (the
// copies' bytes) and an "empty" one (one arrival of the consuming
// warpgroup). The grid is persistent: one block per SM walks the tiles
// (row band outer, columns inner) from its own start with the grid's
// stride.
//
// Epilogue. A warpgroup writes its tile, the epilogue applied, a 64-row
// half at a time into its own 16 KB staging buffer in shared memory
// (stmatrix, in the TMA's 128-byte swizzle, so no lane shuffles and no
// bank conflicts), and its thread 0 stores each half by TMA (rows >= M
// clipped). fc2's residual half tile comes into the same buffer by TMA,
// the first while the warpgroup's products run, the second once the
// first half's store has read the buffer, and is read with ldmatrix in
// the accumulators' layout. Shared memory: six stages, two staging
// buffers and 1 KB to align the swizzle atoms, 230,400 bytes. A first
// version went from registers to device memory through vit_gemm.cuh's
// quad transpose, 16-byte stores and __ldcg residual loads: its epilogue
// took 3.5 times fc1's products and longer than fc2's (PERF.md).
// A version in 2-block clusters that shared each W slice by TMA multicast
// measured 1.7-2.1 times slower and was removed (PERF.md).
//
// Role branches test a warp-uniform warpgroup index, single-thread copies
// are predicated in PTX and the mbarrier waits loop in PTX, so ptxas keeps
// the wgmma asynchronous (PERF.md).
//
// What bounds it on an H100: tensor-core throughput (fc1 and fc2 at B =
// 128: 155 GFLOP each, 0.157 ms at 989 TFLOP/s), then shared memory: by
// count, the products of a 128 x 128 tile read A and W from it at 96
// bytes a cycle at the full rate and the ring fills it at 64, against the
// 128 bytes a cycle it serves, so the products alone can reach at most
// ~0.8 of the peak. fc1's GELU (an erff a hidden value, 101 M a call)
// takes about as long as its products (PERF.md).

#pragma once

#include "vit_gemm.cuh"

namespace {

constexpr int PP_WG = 128;                   // threads of a warpgroup
constexpr int PP_THREADS = 3 * PP_WG;        // two consumers, a producer
constexpr int PP_BM = 128;                   // rows of a warpgroup's tile
constexpr int PP_BN = 128;                   // columns of a tile
constexpr int PP_BK = 64;                    // depth of a ring slice
constexpr int PP_STAGES = 6;
constexpr int PP_A_ELEMS = PP_BM * PP_BK;    // an A slice [128][64]
constexpr int PP_ATOM_ELEMS = PP_BK * 64;    // a W atom [64][64]
constexpr int PP_STAGE_ELEMS = PP_A_ELEMS + 2 * PP_ATOM_ELEMS;
constexpr int PP_STAGE_BYTES = PP_STAGE_ELEMS * 2;
constexpr int PP_BOX_ELEMS = 64 * 64;        // a staged [64][64] box
constexpr int PP_OUT_ELEMS = 2 * PP_BOX_ELEMS;  // a staged half tile
constexpr int PP_OUT_BYTES = PP_OUT_ELEMS * 2;
constexpr int PP_SMEM =
    PP_STAGES * PP_STAGE_BYTES + 2 * PP_OUT_BYTES + VG_ALIGN;

// one Dense: out = epi(a . w (+ residual)), a [M, K], w [K, N], out and
// residual [M, N], with their TMA maps
struct PingPongDense {
  CUtensorMap a_map;    // boxes of 128 rows x 64 columns
  CUtensorMap w_map;    // boxes of 64 rows x 64 columns
  CUtensorMap out_map;  // boxes of 64 rows x 64 columns
  CUtensorMap res_map;  // the same (out's when there is no residual)
  int M, K, N;
};

inline cudaError_t pingpong_dense(PingPongDense* d, const void* a,
                                  const void* w, void* out,
                                  const void* residual, int M, int K, int N) {
  d->M = M;
  d->K = K;
  d->N = N;
  cudaError_t err = bf16_map(&d->a_map, a, M, K, PP_BM);
  if (err == cudaSuccess) err = bf16_map(&d->w_map, w, K, N, PP_BK);
  if (err == cudaSuccess) err = bf16_map(&d->out_map, out, M, N, 64);
  if (err == cudaSuccess)
    err = bf16_map(&d->res_map, residual != nullptr ? residual : out, M, N,
                   64);
  return err;
}

// ------------------------------------------------------ pair epilogues

__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}

// fc1: bf16(gelu(acc + bias)) on columns n, n + 1 (BiasGelu's arithmetic,
// its form fixed at compile time)
template <int MODE>
struct PingPongGelu {
  static constexpr bool kResidual = false;
  const __nv_bfloat16* bias;  // [N] bf16

  __device__ __forceinline__ float2 bias2(int n) const {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + n));
  }

  __device__ __forceinline__ uint32_t operator()(float a0, float a1,
                                                 float2 b, uint32_t) const {
    return pack2(gelu(a0 + b.x, MODE), gelu(a1 + b.y, MODE));
  }
};

// fc2: bf16((residual + acc) + bias) on columns n, n + 1 (ResidualBias's
// arithmetic); the residual pair r arrives staged
struct PingPongResidual {
  static constexpr bool kResidual = true;
  const __nv_bfloat16* bias;  // [N] bf16

  __device__ __forceinline__ float2 bias2(int n) const {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + n));
  }

  __device__ __forceinline__ uint32_t operator()(float a0, float a1,
                                                 float2 b, uint32_t r) const {
    const float2 rf = unpack2(r);
    return pack2((rf.x + a0) + b.x, (rf.y + a1) + b.y);
  }
};

// ------------------------------------------- barriers across warpgroups

// named barrier `id` of `count` threads: wait, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// mbar_arrive by the threads with p set, the predicate in PTX
__device__ __forceinline__ void mbar_arrive_if(bool p, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %1, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(static_cast<int>(p))
      : "memory");
}

// ------------------------------------------------ staging and stores

// four 8x8 b16 matrices from registers; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void stsm_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// by the threads with p set: the [64][64] box at src (the 128-byte
// swizzle) to (column c, row r) of the map, rows past the tensor dropped;
// committed as this thread's bulk group
__device__ __forceinline__ void tma_store_if(bool p, const CUtensorMap* map,
                                             const void* src, int c, int r) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %4, 0;\n"
      "@q cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(r), "r"(static_cast<int>(p))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory (READ) or are
// done
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// element (r, c) of a staged [64][128] half tile: two [64][64] boxes, each
// row 128 bytes with the 16-byte chunks in the TMA's 128-byte swizzle
__device__ __forceinline__ int staged(int r, int c) {
  return (c >> 6) * PP_BOX_ELEMS + r * 64 +
         ((((c >> 3) & 7) ^ (r & 7)) << 3);
}

// ------------------------------------------------------------ the walk

struct PingPongRing {
  uint64_t full[PP_STAGES];
  uint64_t empty[PP_STAGES];
  uint64_t residual[2];  // a warpgroup's residual half tile staged
};

// a block's tiles: tile u is row band u / nt and column tile u % nt (nt
// column tiles a band); block b takes tiles b, b + grid, b + 2 grid, ...
struct PingPongWalk {
  int nt, nk, total, tiles;

  __device__ __forceinline__ explicit PingPongWalk(const PingPongDense& d) {
    nt = d.N / PP_BN;
    nk = d.K / PP_BK;
    total = (d.M + PP_BM - 1) / PP_BM * nt;
    tiles = blockIdx.x < total
                ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x
                : 0;
  }

  // the row band of the block's tile j
  __device__ __forceinline__ int band(int j) const {
    return (blockIdx.x + j * gridDim.x) / nt;
  }

  __device__ __forceinline__ int column(int j) const {
    return (blockIdx.x + j * gridDim.x) % nt * PP_BN;
  }
};

// the producer (one thread): every slice of the block's tiles, in order
__device__ __forceinline__ void pingpong_produce(const PingPongDense& d,
                                                 __nv_bfloat16* stages,
                                                 PingPongRing& ring) {
  const PingPongWalk w(d);
  int i = 0;
  for (int j = 0; j < w.tiles; ++j) {
    const int row = w.band(j) * PP_BM;
    const int n0 = w.column(j);
    for (int kt = 0; kt < w.nk; ++kt, ++i) {
      const int s = i % PP_STAGES;
      mbar_wait(&ring.empty[s], ((i / PP_STAGES) & 1) ^ 1);
      mbar_expect(&ring.full[s], PP_STAGE_BYTES);
      __nv_bfloat16* st = stages + s * PP_STAGE_ELEMS;
      tma_load(st, &d.a_map, &ring.full[s], kt * PP_BK, row);
      tma_load(st + PP_A_ELEMS, &d.w_map, &ring.full[s], n0, kt * PP_BK);
      tma_load(st + PP_A_ELEMS + PP_ATOM_ELEMS, &d.w_map, &ring.full[s],
               n0 + 64, kt * PP_BK);
    }
  }
}

// stage s read by the warpgroup (its wgmma are done): one arrival on the
// stage's empty barrier, by thread 0 of the warpgroup
__device__ __forceinline__ void pingpong_release(PingPongRing& ring, int s) {
  mbar_arrive_if(threadIdx.x % PP_WG == 0, &ring.empty[s]);
}

// warpgroup wg's tiles j = wg, wg + 2, ...: the products of each (after the
// other warpgroup has issued those of tile j - 1), then its epilogue while
// the other's products run
template <class Epilogue>
__device__ __forceinline__ void pingpong_consume(const PingPongDense& d,
                                                 const Epilogue& epi,
                                                 __nv_bfloat16* stages,
                                                 PingPongRing& ring, int wg) {
  const PingPongWalk w(d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // thread 0 of the warpgroup issues its copies and stores (predicated)
  const bool issuer = threadIdx.x % PP_WG == 0;
  __nv_bfloat16* out =
      stages + PP_STAGES * PP_STAGE_ELEMS + wg * PP_OUT_ELEMS;
  // by the issuer, once its last store has read the staging buffer: the
  // residual rows m .. m + 63 of columns n0 .. n0 + 127 into it
  const auto stage_residual = [&](int m, int n0) {
    bulk_wait<true>();
    mbar_expect_if(issuer, &ring.residual[wg], PP_OUT_BYTES);
    tma_load_if(issuer, out, &d.res_map, &ring.residual[wg], n0, m);
    tma_load_if(issuer, out + PP_BOX_ELEMS, &d.res_map, &ring.residual[wg],
                n0 + 64, m);
  };
  // lane l addresses row l % 8 of matrix l / 8: rows 8 (l / 8 % 2) + ..
  // of n8 tile 2 tp + l / 16; its register i holds matrix i's pair of row
  // l / 4, columns 2 (l % 4) and + 1: the accumulators of tile 2 tp + i /
  // 2, rows + 8 (i % 2)
  const int row = 16 * (warp & 3) + 8 * ((lane >> 3) & 1) + (lane & 7);
  const int col = 8 * (lane >> 4);
  float acc[2][64];
  for (int j = wg; j < w.tiles; j += 2) {
    if (j > 0) named_sync(1 + wg, 2 * PP_WG);
    const int m0 = w.band(j) * PP_BM;
    const int n0 = w.column(j);
    if (Epilogue::kResidual) stage_residual(m0, n0);
    const int first = j * w.nk;
    for (int kt = 0; kt < w.nk; ++kt) {
      const int i = first + kt;
      const int s = i % PP_STAGES;
      mbar_wait(&ring.full[s], (i / PP_STAGES) & 1);
      const __nv_bfloat16* st = stages + s * PP_STAGE_ELEMS;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < PP_BK / 16; ++kk) {
        // W: LBO one atom (8 KB), SBO 8 rows x 128 bytes; k16 step kk is 16
        // rows down
        const uint64_t db = wg_desc(st + PP_A_ELEMS + 16 * kk * 64,
                                    PP_ATOM_ELEMS * 2, 1024, 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // A: rows 64 h ..; SBO 8 rows x 128 bytes; k16 step kk is 32
          // bytes into the rows
          const uint64_t da =
              wg_desc(st + 64 * h * PP_BK + 16 * kk, 16, 1024, 1);
          wgmma_128(acc[h], da, db, kt > 0 || kk > 0);
        }
      }
      wg_commit();
      wg_wait<1>();  // the products of the previous slice are done
      if (kt > 0) pingpong_release(ring, (i - 1) % PP_STAGES);
    }
    // the other warpgroup may issue its next tile's products
    if (j + 1 < w.tiles) named_arrive(2 - wg, 2 * PP_WG);
    wg_wait<0>();
    pingpong_release(ring, (first + w.nk - 1) % PP_STAGES);
    // the epilogue, a 64-row half h at a time through the staging buffer
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (Epilogue::kResidual) {
        // the residual half staged (the second once the first's store has
        // read the buffer)
        if (h == 1) stage_residual(m0 + 64, n0);
        mbar_wait(&ring.residual[wg], h);
      } else {
        // the buffer free: its last store has read it
        bulk_wait<true>();
        named_sync(3 + wg, PP_WG);
      }
#pragma unroll
      for (int tp = 0; tp < 8; ++tp) {
        const int t = 2 * tp;
        const float2 b0 = epi.bias2(n0 + 8 * t + 2 * (lane & 3));
        const float2 b1 = epi.bias2(n0 + 8 * t + 8 + 2 * (lane & 3));
        __nv_bfloat16* p = out + staged(row, 16 * tp + col);
        uint32_t r[4] = {0, 0, 0, 0};
        if (Epilogue::kResidual) ldsm_x4(r, p);
        const uint32_t o[4] = {
            epi(acc[h][4 * t], acc[h][4 * t + 1], b0, r[0]),
            epi(acc[h][4 * t + 2], acc[h][4 * t + 3], b0, r[1]),
            epi(acc[h][4 * t + 4], acc[h][4 * t + 5], b1, r[2]),
            epi(acc[h][4 * t + 6], acc[h][4 * t + 7], b1, r[3])};
        stsm_x4(p, o);
      }
      // the half by TMA, once every thread's writes are visible to it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, PP_WG);
      tma_store_if(issuer, &d.out_map, out, n0, m0 + 64 * h);
      tma_store_if(issuer, &d.out_map, out + PP_BOX_ELEMS, n0 + 64,
                   m0 + 64 * h);
      bulk_commit();
    }
  }
  bulk_wait<false>();  // the stores are done before the block leaves
}

template <class Epilogue>
__global__ void __launch_bounds__(PP_THREADS, 1)
    vit_pingpong(const __grid_constant__ PingPongDense d, const Epilogue epi) {
  extern __shared__ __align__(128) unsigned char vit_pingpong_smem[];
  __shared__ PingPongRing ring;
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(align_atoms(vit_pingpong_smem));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < PP_STAGES; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 1);
    }
    mbar_init(&ring.residual[0], 1);
    mbar_init(&ring.residual[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the consumers take 232 registers a thread, the producer warpgroup
  // (one thread of which issues the copies) keeps 40
  const int wg = warpgroup();
  if (wg < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    pingpong_consume(d, epi, stages, ring, wg);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * PP_WG) pingpong_produce(d, stages, ring);
  }
}

// out = epi(a [M, K] . w [K, N] (+ residual [M, N])) on `grid` blocks, at
// most one an SM (ops/vit_mlp.py::mlp_geometry); residual given exactly
// when the epilogue takes one
template <class Epilogue>
cudaError_t launch_vit_pingpong(const void* a, const void* w, void* out,
                                const void* residual, int M, int K, int N,
                                const Epilogue& epi, int grid,
                                cudaStream_t stream) {
  if (grid < 1 || M < 1 || K % PP_BK || N % PP_BN ||
      Epilogue::kResidual != (residual != nullptr))
    return cudaErrorInvalidValue;
  PingPongDense d;
  cudaError_t err = pingpong_dense(&d, a, w, out, residual, M, K, N);
  if (err != cudaSuccess) return err;
  const auto kernel = vit_pingpong<Epilogue>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PP_THREADS, PP_SMEM, stream>>>(d, epi);
  return cudaGetLastError();
}

}  // namespace
