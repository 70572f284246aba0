// The ViT's opt-in attention kernels on Hopper (sm_90a), bf16 in and out,
// f32 accumulation: softmax(q . k^T * scale) . v per (image, head), heads of
// 64, the exact softmax (divide by the row sum before the value
// contraction), key columns >= kv_valid masked.
//
// Replace three TPU kernels of multimodal_baby_tpu/ops/attention.py:
//   K8a fused_attention (`_attn_kernel`): q, k, v heads-first [B*H, N, 64];
//       p stays f32 into the value contraction;
//   K8b fused_attention_pairs (`_attn_pairs_kernel`): q, k, v token-major
//       [B, N, C] (any row stride: the column slices of the qkv projection's
//       [B, N, 3C] output are read in place); p rounded to bf16;
//   K8c fused_qkv_attention_pairs (`_qkv_attn_pairs_kernel`): the qkv
//       projection inside, q, k, v = bf16(bf16(x . W) + b), then K8b's
//       attention (p rounded to bf16).
// The TPU kernels pack two heads into one 128-lane contraction (their +/-
// trick) to fill the TPU's matrix unit; here each warp computes one head's
// scores directly as q . k^T on the tensor cores.
//
// What bounds them on an H100: at ViT-B/14 and B = 128, K8a/K8b do 26.0
// GFLOP on 202 MB (bytes: 0.060 ms at 3.35 TB/s) and K8c 142.4 GFLOP on
// 105 MB (operations: 0.144 ms at 989 TFLOP/s).
//
// All three run the register-resident core of attn_mma.cuh (mma.sync
// m16n8k16, the scores of 16 query rows against up to 272 keys held in a
// warp's registers, one Q . K^T pass, p packed from the accumulators into
// the value product's operands). The launch geometry (key chunks, threads,
// dynamic shared memory) comes from ops/attention.py::attention_geometry.
//
// K8a and K8b: attn_mma.cuh's attention_mma (which K5 launches too, in
// its deferred mode), one block per (head, image),
// q, k and v read in place through their strides (K8b's are the column
// slices of the qkv tensor, row stride 3C: no heads-first copy). K and V
// of the head's N keys are
// loaded once into swizzled shared memory (256 bytes a row for rows up to
// the last chunk's start + 272: 69,632 at N = 257, 200,704 at N = 752),
// one cp.async group per key chunk and one for
// V, so the first slabs' scores start as soon as their chunk lands and V
// lands during the softmax. The block's warps (min(4, np / 16)) walk the
// np / 16 slabs of 16 query rows; a warp reads its Q fragments straight
// from device memory into registers. No warp is given an all-padding slab
// (N = 257: 17 slabs, not the 20 of 64-row tiles). K8b rounds p to bf16
// in the A fragments of one P . V product, as the TPU kernel's
// p.astype(bf16). K8a (P_F32) keeps p at f32 grade: it goes
// through the bf16 tensor cores as bf16(p) + bf16(p - bf16(p)) against the
// exact bf16 V, two products per fragment: p to ~2^-16 of itself, as the
// TPU kernel's f32 dot. __launch_bounds__(128, 2): up to 255 registers a
// thread (136 of them the scores), two blocks per SM up to N = 352 (by
// shared memory), one above. Rows of one chunk (np <= 272) and the
// two-pass rows are separate kernels (the SINGLE template argument).
//
// K8c: one block of 4 warps (one warpgroup) per (head, image). Phase 1
// projects the head's K and V for every token row in rounds of 64 rows: a
// wgmma m64n128k16 tile of x . W[:, k | v] (warp w gets rows 16 w .. 16 w
// + 15 in the mma accumulator layout), fed by a three-stage cp.async ring
// of 32-deep slices (x [64][32] K-major with the 64-byte swizzle, W as two
// [32][64] MN-major atoms with the 128-byte swizzle); the epilogue rounds
// bf16(bf16(acc) + b) into the swizzled K and V, rows < np only. Phase 2
// walks the query slabs in rounds of 4 (one a warp): the same ring, a
// m64n64k16 tile of the round's Q; each warp turns its 16 x 64
// accumulators into the A fragments of its Q . K^T in registers (Q never
// goes to shared memory) and runs the attention core. Each step keeps the
// copies of two slices and one wgmma group in flight.
// wgmma, not mma.sync: with 16-row mma.sync warp tiles the projection's
// time went to the per-slice barrier and fragment loads (PERF.md). Its
// cost: 64-row granularity, 320 rows computed at N = 257 (272 loaded and
// stored): 18% more tensor work, no more bytes.
// Shared memory: 256 rows + 37,888 bytes (1 KB of it aligns the swizzle
// atoms), 107,520 at N = 257, so two blocks share an SM and one block's
// projection overlaps the other's attention (one block per SM for the
// two-pass rows, N > 272: K and V then hold the last chunk's start + 272
// rows; N <= 416). What bounds it now: the ring's barrier and copies per
// 32-deep slice (x read twice and W's slices once a round from L2), not
// the tensor cores (PERF.md).

#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------- K8c

constexpr int QM_THREADS = 128;  // one warpgroup: 4 warps, 16 rows each
constexpr int QM_BM = 64;        // token rows a projection round (wgmma m64)
constexpr int QM_BK = 32;        // depth of a ring slice
constexpr int QM_STAGES = 3;     // ring depth
// a ring stage: the x slice [64][32] (4 KB, 64-byte swizzle) at 0, then
// the W slice as [32][64] atoms (4 KB each, 128-byte swizzle): two in phase
// 1 (the head's k and v columns), one in phase 2 (q)
constexpr int QM_X_ELEMS = QM_BM * QM_BK;
constexpr int QM_ATOM_ELEMS = QM_BK * AM_D;
constexpr int QM_STAGE_ELEMS = QM_X_ELEMS + 2 * QM_ATOM_ELEMS;
constexpr int QM_ALIGN = 1024;   // the swizzle atoms' alignment

// element (r, c) of the x slice: K-major, 64-byte swizzle (the 16-byte
// chunk c / 8 of row r at chunk c / 8 ^ (r / 2) % 4), as wgmma reads it
__device__ __forceinline__ int swx(int r, int c) {
  return r * QM_BK + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// element (k, n) of the W slice: MN-major, atoms of 64 columns, each [32
// rows of 128 bytes] with the 128-byte swizzle (chunk n / 8 % 8 of row k at
// chunk (n / 8 ^ k) % 8)
__device__ __forceinline__ int sww(int k, int n) {
  return (n >> 6) * QM_ATOM_ELEMS + sw64(k, n & 63);
}

// acc (+)= x[64 rows] . W[:, cols] over one ring slice (two k16 steps),
// issued and committed as one wgmma group, not waited for: the x
// descriptor steps 32 bytes within its 64-byte rows, W's steps 16 rows of
// 128 bytes; first: the round's first slice (acc overwritten)
template <int NCOLS>
__device__ __forceinline__ void slice_wgmma(const __nv_bfloat16* stage,
                                            float (&acc)[NCOLS / 2],
                                            bool first) {
  const __nv_bfloat16* ws = stage + QM_X_ELEMS;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < QM_BK / 16; ++kk) {
    // x: SBO 8 rows x 64 bytes; W: LBO one atom (4 KB), SBO 8 rows x 128 B
    const uint64_t da = wg_desc(stage + 16 * kk, 16, 8 * QM_BK * 2, 2);
    const uint64_t db = wg_desc(ws + 16 * kk * AM_D, QM_ATOM_ELEMS * 2,
                                8 * AM_D * 2, 1);
    if constexpr (NCOLS == 128)
      wgmma_128(acc, da, db, kk > 0 || !first);
    else
      wgmma_64(acc, da, db, kk > 0 || !first);
  }
  wg_commit();
}

struct QkvArgs {
  const __nv_bfloat16* x;  // the image's [N, C]
  const __nv_bfloat16* w;  // [C, 3C]
  const __nv_bfloat16* b;  // [3C]
  int N, C, head;
};

// ring slice kt of projection round rg into stage: x rows 64 rg .. (rows <
// np, zeros >= N), columns 32 kt ..; and W's head columns, KV: the head's
// k then v columns (two atoms), else its q columns (one atom)
template <bool KV>
__device__ __forceinline__ void load_slice(const QkvArgs& a, int np,
                                           __nv_bfloat16* stage, int rg,
                                           int kt) {
  constexpr int COLS = KV ? 2 * AM_D : AM_D;
  const int tid = threadIdx.x;
  const int k0 = kt * QM_BK;
  const int r0 = rg * QM_BM;
  const int rows = min(QM_BM, np - r0);
  for (int v = tid; v < rows * (QM_BK / 8); v += QM_THREADS) {
    const int r = v >> 2;
    const int ch = v & 3;
    const bool ok = r0 + r < a.N;
    cp_async16(stage + swx(r, ch * 8),
               ok ? a.x + static_cast<size_t>(r0 + r) * a.C + k0 + ch * 8
                  : a.x,
               ok);
  }
  __nv_bfloat16* ws = stage + QM_X_ELEMS;
  const size_t ldw = 3 * static_cast<size_t>(a.C);
  for (int v = tid; v < QM_BK * COLS / 8; v += QM_THREADS) {
    const int k = v / (COLS / 8);
    const int c = (v % (COLS / 8)) * 8;
    // KV: columns C + 64 head + c (k), 2C + 64 head + c - 64 (v)
    const int wc = KV ? (c < AM_D ? a.C : 2 * a.C - AM_D) + a.head * AM_D + c
                      : a.head * AM_D + c;
    cp_async16(ws + sww(k, c), a.w + (k0 + k) * ldw + wc, true);
  }
}

// The projection ring: QM_STAGES stages, slice i of the flattened (round,
// depth) sequence in stage i % QM_STAGES. Step i: ring_wait waits for
// slice i's copies and makes them visible to every thread and to wgmma
// (the async proxy); the step's wgmma group is issued; ring_refill waits
// until only that group is in flight (so step i - 1's group, which read
// the stage of slice i + QM_STAGES - 1, is done) and issues that slice's
// copies. The copies of two slices and one wgmma group overlap every step.
struct RingPos {
  int rg, kt;  // projection round and depth slice
};

__device__ __forceinline__ void advance(RingPos& p, int by, int ktiles) {
  p.kt += by;
  while (p.kt >= ktiles) {
    p.kt -= ktiles;
    ++p.rg;
  }
}

__device__ __forceinline__ __nv_bfloat16* ring_stage(__nv_bfloat16* ring,
                                                     int i) {
  return ring + (i % QM_STAGES) * QM_STAGE_ELEMS;
}

template <bool KV>
__device__ __forceinline__ void ring_start(const QkvArgs& a, int np,
                                           __nv_bfloat16* ring, int steps) {
  const int ktiles = a.C / QM_BK;
  RingPos p{0, 0};
#pragma unroll
  for (int i = 0; i < QM_STAGES - 1; ++i) {
    if (i < steps) load_slice<KV>(a, np, ring_stage(ring, i), p.rg, p.kt);
    cp_async_commit();
    advance(p, 1, ktiles);
  }
}

__device__ __forceinline__ const __nv_bfloat16* ring_wait(
    __nv_bfloat16* ring, int i) {
  cp_async_wait<QM_STAGES - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  return ring_stage(ring, i);
}

template <bool KV>
__device__ __forceinline__ void ring_refill(const QkvArgs& a, int np,
                                            __nv_bfloat16* ring, int steps,
                                            int i, RingPos p) {
  wg_wait<1>();
  const int nx = i + QM_STAGES - 1;
  advance(p, QM_STAGES - 1, a.C / QM_BK);
  if (nx < steps) load_slice<KV>(a, np, ring_stage(ring, nx), p.rg, p.kt);
  cp_async_commit();
}

__device__ __forceinline__ void ring_end() {
  wg_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free again
}

template <bool SINGLE>
__global__ void __launch_bounds__(QM_THREADS, 2)
    qkv_attention_mma(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ b,
                      __nv_bfloat16* __restrict__ y, const AttnGeom gm, int N,
                      int C, int kv_valid, float c) {
  extern __shared__ __align__(128) unsigned char qkv_mma_smem[];
  // the swizzle atoms need 1024-byte alignment (the wrapper adds the slack)
  unsigned char* base =
      qkv_mma_smem + ((QM_ALIGN - (smem_addr(qkv_mma_smem) & (QM_ALIGN - 1))) &
                      (QM_ALIGN - 1));
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Vs = Ks + gm.rows * AM_D;
  __nv_bfloat16* ring = Vs + gm.rows * AM_D;

  const int head = blockIdx.x;
  const int img = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int cq = 2 * (lane & 3);
  const QkvArgs a{x + static_cast<size_t>(img) * N * C, w, b, N, C, head};
  const int ktiles = C / QM_BK;
  const int rounds = (gm.np + QM_BM - 1) / QM_BM;
  // the rows of K and V past np, which the attention core reads with p = 0
  for (int v = threadIdx.x; v < (gm.rows - gm.np) * AM_D / 8;
       v += QM_THREADS) {
    reinterpret_cast<uint4*>(Ks + gm.np * AM_D)[v] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(Vs + gm.np * AM_D)[v] = make_uint4(0, 0, 0, 0);
  }

  // phase 1: K and V of every token row, 64 rows a round (the warpgroup's
  // 64 x 128 wgmma tile; warp w holds rows 16 w .. 16 w + 15 in the mma
  // accumulator layout)
  {
    const int steps = rounds * ktiles;
    float acc[64];
    ring_start<true>(a, gm.np, ring, steps);
    RingPos p{0, 0};
    for (int i = 0; i < steps; ++i, advance(p, 1, ktiles)) {
      slice_wgmma<128>(ring_wait(ring, i), acc, p.kt == 0);
      ring_refill<true>(a, gm.np, ring, steps, i, p);
      const int row = p.rg * QM_BM + warp * 16;
      if (p.kt < ktiles - 1) continue;
      wg_wait<0>();
      if (row >= gm.np) continue;
      // bf16(bf16(acc) + b) into K (tiles 0-7) and V (8-15); rows >= N zero
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int d = 8 * (t & 7) + cq;
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
            b + (t < 8 ? C : 2 * C) + head * AM_D + d);
        const float b0 = __bfloat162float(bb.x);
        const float b1 = __bfloat162float(bb.y);
        __nv_bfloat16* dst = t < 8 ? Ks : Vs;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + g + 8 * h;
          const uint32_t val =
              r < N ? pack_bf16(round_bf16(acc[4 * t + 2 * h]) + b0,
                                round_bf16(acc[4 * t + 2 * h + 1]) + b1)
                    : 0u;
          *reinterpret_cast<uint32_t*>(dst + sw64(r, d)) = val;
        }
      }
    }
    ring_end();
  }

  // phase 2: rounds of 4 slabs (one a warp): the round's Q on a 64 x 64
  // wgmma tile, each warp's 16 rows turned into the A fragments of its
  // Q . K^T in registers, then its attention against the whole of K and V
  {
    const int steps = rounds * ktiles;
    float acc[32];
    ring_start<false>(a, gm.np, ring, steps);
    RingPos p{0, 0};
    for (int i = 0; i < steps; ++i, advance(p, 1, ktiles)) {
      slice_wgmma<64>(ring_wait(ring, i), acc, p.kt == 0);
      ring_refill<false>(a, gm.np, ring, steps, i, p);
      const int row = p.rg * QM_BM + warp * 16;
      if (p.kt < ktiles - 1) continue;
      wg_wait<0>();
      if (row >= gm.np) continue;
      // q = bf16(bf16(acc) + b) as A fragments: k step kd takes tiles 2 kd
      // (columns 16 kd + cq) and 2 kd + 1 (+ 8)
      uint32_t qa[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
            b + head * AM_D + 8 * t + cq);
        const float b0 = __bfloat162float(bb.x);
        const float b1 = __bfloat162float(bb.y);
        qa[t >> 1][(t & 1) * 2] = pack_bf16(round_bf16(acc[4 * t]) + b0,
                                            round_bf16(acc[4 * t + 1]) + b1);
        qa[t >> 1][(t & 1) * 2 + 1] =
            pack_bf16(round_bf16(acc[4 * t + 2]) + b0,
                      round_bf16(acc[4 * t + 3]) + b1);
      }
      float o[8][4];
      attention_slab<P_BF16, SINGLE>(qa, Ks, Vs, gm, kv_valid, c, false,
                                     o);
      store_slab(o,
                 y + (static_cast<size_t>(img) * N + row) * C + head * AM_D,
                 C, N - row);
    }
    ring_end();
  }
}

// K8a (P_F32) or K8b (P_BF16) with the geometry of
// ops/attention.py::attention_geometry
template <int MODE>
int launch_attention(const void* q, const void* k, const void* v, void* y,
                     long long q_bs, long long k_bs, long long v_bs,
                     long long y_bs, int q_rs, int k_rs, int v_rs, int y_rs,
                     int images, int heads, int N, int kv_valid, float scale,
                     int np, int kc, int nchunks, int rows, int threads,
                     int smem, void* stream) {
  const AttnIO io{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v),
                  static_cast<__nv_bfloat16*>(y),
                  q_bs, k_bs, v_bs, y_bs, q_rs, k_rs, v_rs, y_rs};
  return static_cast<int>(launch_attention_mma<MODE>(
      io, images, heads, N, kv_valid, scale, AttnGeom{np, kc, nchunks, rows},
      threads, smem, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Shapes, strides and alignment are checked by the Python wrappers
// (multimodal_baby_tpu_torch/ops/attention.py): bf16, heads of 64, 1 <=
// kv_valid <= N <= 752 (K8c: 416, and C % 64 == 0), every pointer and
// stride 16-byte aligned, the last axis contiguous. Strides are in
// elements. Each returns the first CUDA error, or 0.

// K8b: q, k, v, y token-major (image stride *_bs, row stride *_rs), heads
// of 64 side by side; the geometry as K8a's
extern "C" int mmb_attention_bf16(
    const void* q, const void* k, const void* v, void* y, long long q_bs,
    long long k_bs, long long v_bs, long long y_bs, int q_rs, int k_rs,
    int v_rs, int y_rs, int images, int heads, int N, int kv_valid,
    float scale, int np, int kc, int nchunks, int rows, int threads,
    int smem, void* stream) {
  return launch_attention<P_BF16>(q, k, v, y, q_bs, k_bs, v_bs, y_bs, q_rs,
                                 k_rs, v_rs, y_rs, images, heads, N, kv_valid,
                                 scale, np, kc, nchunks, rows, threads, smem,
                                 stream);
}

// K8a: q, k, v, y heads-first ([B*H, N, 64]: images = B*H, heads = 1)
extern "C" int mmb_attention_f32p_bf16(
    const void* q, const void* k, const void* v, void* y, long long q_bs,
    long long k_bs, long long v_bs, long long y_bs, int q_rs, int k_rs,
    int v_rs, int y_rs, int images, int heads, int N, int kv_valid,
    float scale, int np, int kc, int nchunks, int rows, int threads,
    int smem, void* stream) {
  return launch_attention<P_F32>(q, k, v, y, q_bs, k_bs, v_bs, y_bs, q_rs,
                                k_rs, v_rs, y_rs, images, heads, N, kv_valid,
                                scale, np, kc, nchunks, rows, threads, smem,
                                stream);
}

// K8c: x [B, N, C], w [C, 3C] (columns (q | k | v) x (head, feature)), b
// [3C], y [B, N, C]; the geometry as K8a's (threads = 128)
extern "C" int mmb_qkv_attention_bf16(const void* x, const void* w,
                                      const void* b, void* y, int B, int N,
                                      int C, int kv_valid, float scale,
                                      int np, int kc, int nchunks,
                                      int rows, int threads, int smem,
                                      void* stream) {
  const auto kernel =
      nchunks == 1 ? qkv_attention_mma<true> : qkv_attention_mma<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(C / AM_D, B), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
      AttnGeom{np, kc, nchunks, rows}, N, C, kv_valid, scale * AM_LOG2E);
  return static_cast<int>(cudaGetLastError());
}
