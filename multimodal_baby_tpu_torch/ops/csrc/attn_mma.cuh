// The attention core of K5 (vit_attention.cu, vit_block.cu) and K8a-c
// (attention.cu) on Hopper's warp-level tensor-core product, mma.sync
// m16n8k16 (bf16 in, f32 sums), in inline PTX, with fragments loaded by
// ldmatrix.
//
// One warp owns 16 query rows of one head (a "slab") and holds their
// scores against a chunk of up to AM_CHUNK = 272 keys in registers, in the
// m16n8 accumulator layout: 34 n8 tiles x 4 f32 a thread. A thread holds
// rows g = lane / 4 and g + 8, columns 2 (lane % 4) and + 1 of each tile,
// so a row's max and sum take two quad shuffles (xor 1, xor 2). Two n8
// tiles of p are one k16 A fragment of the value product: p goes from the
// accumulators into the P . V operands without touching shared memory.
//
// Three softmax modes (attention_slab's MODE):
//   P_F32, P_BF16: the TPU kernels' exact one, p = exp(s scale - max) /
//     sum, divided before the value contraction; p at f32 grade (K8a) or
//     rounded to bf16 (K8b, K8c);
//   P_DEFER: K5's deferred one, e = exp(s scale - max), z summed from the
//     unrounded e, bf16(e) into the value product, the output multiplied
//     by 1 / z and rounded once: y = bf16((bf16(e) . v) (1 / z)).
// Each with rewrites that move p by a few ulp
// (tests/test_torch_attention_order.py emulates them on the CPU and holds
// them to the JAX kernels): exp(s scale - m) is computed as 2^(s c - m')
// with c = scale * log2(e) folded into the score (m' the max of s c) on the
// special-function unit (ex2.approx), and one reciprocal per row. Keys >=
// kv_valid get s = -inf, whose 2^s is exactly 0 (the TPU kernels add
// -1e9).
//
// Rows of up to 272 keys (ViT-B/14: N = 257, np = 272) take one pass: the
// scores are computed once, exponentiated in place and contracted with V.
// Longer rows (np up to 752) run the same routine over key chunks of kc
// keys in two passes, statistics first (max and sum carried online from
// chunk to chunk: z = z 2^(m - m_new) + sum 2^(s c - m_new)), then p
// chunk by chunk with the scores recomputed. The wrapper
// (ops/attention.py::attention_geometry) chooses kc and the chunk count.
//
// K and V live in shared memory as [rows][64] bf16, 128 bytes a row, with
// the 16-byte chunk c of row r stored at chunk c ^ (r & 7): the eight rows
// an ldmatrix reads (keys, in K . and V) fall in eight different bank
// groups, with no padding.
//
// attention_mma is the launch of K5's, K8a's and K8b's attention: one
// block per (head, image), q, k, v and y read and written in place through
// their strides (AttnIO).

#pragma once

#include "common.cuh"

namespace {

constexpr int AM_D = 64;          // head width
constexpr int AM_CHUNK = 272;     // keys whose scores a warp holds at once
constexpr int AM_NT = AM_CHUNK / 8;  // n8 score tiles: 136 f32 registers
constexpr float AM_LOG2E = 1.44269504088896341f;

// attention_slab's softmax modes (see the top of the file)
constexpr int P_F32 = 0;    // K8a
constexpr int P_BF16 = 1;   // K8b, K8c
constexpr int P_DEFER = 2;  // K5, K7

// element (r, c) of a swizzled [rows][64] bf16 tile (8 chunks a row)
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a . b on a 16x8x16 tile: a row-major (4 registers), b column-major
// (2 registers), d f32 (row lane / 4: d0 d1; row lane / 4 + 8: d2 d3)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error
// ~2^-22, results below 2^-126 flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

// rows [r0, r1) of one head's 64 columns at src (row pitch rs elements)
// into the swizzled tile dst, rows >= valid zero-filled; threads tid of
// nthreads share the copies (cp.async through L2, not committed)
__device__ __forceinline__ void load_rows_sw(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             size_t rs, int valid, int r0,
                                             int r1, int tid, int nthreads) {
  for (int v = tid; v < (r1 - r0) * 8; v += nthreads) {
    const int row = r0 + (v >> 3);
    const int ch = v & 7;
    const bool ok = row < valid;
    cp_async16(dst + sw64(row, ch * 8), (ok ? src + row * rs : src) + ch * 8,
               ok);
  }
}

// cp.async.wait_group with a count known only at run time (0 .. 4)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// key chunks of one row: kc keys each (a multiple of 16), the last np -
// (nchunks - 1) kc; set by the wrapper
struct AttnGeom {
  int np;       // N rounded up to 16
  int kc;       // keys a chunk, <= AM_CHUNK
  int nchunks;  // ceil(np / kc)
  int rows;     // K and V rows in shared memory: (nchunks - 1) kc + 272,
                // those >= N zero
};

// Every routine below runs over all AM_NT tiles of a chunk, with no branch
// on the chunk's length: K and V hold rows up to the last chunk's start +
// 272 (zeros past N), and keys past the chunk or >= kv_valid are masked to
// p = 0, so ptxas can interleave the loads, products and exponentials of
// neighbouring tiles and address every tile from one base register (a
// key's swizzle depends on key % 8 alone). A chunk shorter than 272 keys
// (N < 257, the last chunk of a long row) pays for 272.

// s[t] = Q . K^T for keys k0 + 8t .. + 7; K swizzled
__device__ __forceinline__ void chunk_scores(const uint32_t (&qa)[4][4],
                                             const __nv_bfloat16* Ks, int k0,
                                             float (&s)[AM_NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < AM_NT; ++t) {
    // matrices: keys k0 + 8t + (lane % 8), columns 8 (lane / 8) (+ 32)
    const int key = k0 + 8 * t + (lane & 7);
    uint32_t b[4], b2[4];
    ldsm_x4(b, Ks + sw64(key, (lane >> 3) * 8));
    ldsm_x4(b2, Ks + sw64(key, 32 + (lane >> 3) * 8));
    s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
    mma_bf16(s[t], qa[0], b[0], b[1]);
    mma_bf16(s[t], qa[1], b[2], b[3]);
    mma_bf16(s[t], qa[2], b2[0], b2[1]);
    mma_bf16(s[t], qa[3], b2[2], b2[3]);
  }
}

// s = s c at keys < lim, -inf at the others; returns the max of rows g
// (mx[0]) and g + 8 (mx[1]) over the chunk, quad-reduced
__device__ __forceinline__ void chunk_scale_max(float (&s)[AM_NT][4], int k0,
                                                int lim, float c,
                                                float (&mx)[2]) {
  const int col = k0 + 2 * (threadIdx.x & 3);
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int t = 0; t < AM_NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = col + 8 * t + (e & 1) < lim ? s[t][e] * c : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
}

// o += P . V over the chunk's keys k0 .. k0 + 271 (P is 0 past the
// chunk), P from the score registers; SPLIT: P at f32 grade as bf16(P) +
// bf16(P - bf16(P)), two products against the same V fragments (K8a), else
// P rounded to bf16
template <bool SPLIT>
__device__ __forceinline__ void chunk_pv(const float (&p)[AM_NT][4],
                                         const __nv_bfloat16* Vs, int k0,
                                         float (&o)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < AM_NT / 2; ++j) {
    const float(&p0)[4] = p[2 * j];
    const float(&p1)[4] = p[2 * j + 1];
    const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                           pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
    uint32_t lo[4];
    if constexpr (SPLIT) {
      float r[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = p0[e] - round_bf16(p0[e]);
        r[4 + e] = p1[e] - round_bf16(p1[e]);
      }
      lo[0] = pack_bf16(r[0], r[1]);
      lo[1] = pack_bf16(r[2], r[3]);
      lo[2] = pack_bf16(r[4], r[5]);
      lo[3] = pack_bf16(r[6], r[7]);
    }
    // V^T fragments: keys k0 + 16j + (lane % 16), columns 16 dp + 8 (lane /
    // 16); registers 0, 1 feed output tile 2 dp, 2 and 3 tile 2 dp + 1
    const int key = k0 + 16 * j + (lane & 15);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Vs + sw64(key, 16 * dp + (lane >> 4) * 8));
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      if constexpr (SPLIT) {
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

// One warp, one slab: o = softmax(Q K^T scale) V over the np keys of the
// geometry, keys >= kv_valid masked (kv_valid >= 1), c = scale log2(e),
// in the softmax mode MODE (P_DEFER: o is already multiplied by 1 / z).
// SINGLE: the geometry has one chunk (np <= 272), compiled apart from the
// two-pass code so that neither pays the other's registers.
// first: the block's first round, whose K chunks and V are still landing
// (one cp.async group per K chunk, then one for V): each chunk is waited
// for, with a block barrier, just before its scores, and V before the
// first value product. Every warp of the block must take part in it.
template <int MODE, bool SINGLE>
__device__ __forceinline__ void attention_slab(const uint32_t (&qa)[4][4],
                                               const __nv_bfloat16* Ks,
                                               const __nv_bfloat16* Vs,
                                               const AttnGeom& gm,
                                               int kv_valid, float c,
                                               bool first,
                                               float (&o)[8][4]) {
  float s[AM_NT][4];
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f};
  // pass 1: the row statistics (and, for one chunk, p itself)
  const int nchunks = SINGLE ? 1 : gm.nchunks;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int k0 = ch * gm.kc;
    const int lim = min(kv_valid, k0 + gm.kc);
    if (first) {
      cp_async_wait_n(nchunks - ch);  // chunk ch has landed
      __syncthreads();
    }
    chunk_scores(qa, Ks, k0, s);
    float mx[2];
    chunk_scale_max(s, k0, lim, c, mx);
    // key 0 is valid, so the max is finite from the first chunk on
    const float mn[2] = {fmaxf(m[0], mx[0]), fmaxf(m[1], mx[1])};
    float add[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < AM_NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = ex2(s[t][e] - mn[e >> 1]);
        if constexpr (SINGLE) s[t][e] = v;
        add[e >> 1] += v;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      z[i] = z[i] * ex2(m[i] - mn[i]) + add[i];
      m[i] = mn[i];
    }
  }
  float rz[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
    rz[i] = 1.0f / z[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  if (first) {
    cp_async_wait<0>();  // V
    __syncthreads();
  }
  constexpr bool SPLIT = MODE == P_F32;
  if constexpr (SINGLE) {
    if constexpr (MODE != P_DEFER) {
#pragma unroll
      for (int t = 0; t < AM_NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] *= rz[e >> 1];
      }
    }
    chunk_pv<SPLIT>(s, Vs, 0, o);
  } else {
    // pass 2: p chunk by chunk, the scores recomputed
    for (int ch = 0; ch < gm.nchunks; ++ch) {
      const int k0 = ch * gm.kc;
      chunk_scores(qa, Ks, k0, s);
      float mx[2];
      chunk_scale_max(s, k0, min(kv_valid, k0 + gm.kc), c, mx);
#pragma unroll
      for (int t = 0; t < AM_NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = ex2(s[t][e] - m[e >> 1]);
          if constexpr (MODE != P_DEFER) s[t][e] *= rz[e >> 1];
        }
      }
      chunk_pv<SPLIT>(s, Vs, k0, o);
    }
  }
  if constexpr (MODE == P_DEFER) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= rz[e >> 1];
  }
}

// rows [0, valid) of the slab: out[row * rs + d] = bf16(o)
__device__ __forceinline__ void store_slab(const float (&o)[8][4],
                                           __nv_bfloat16* out, size_t rs,
                                           int valid) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int d = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (g < valid)
      *reinterpret_cast<uint32_t*>(out + g * rs + 8 * j + d) =
          pack_bf16(o[j][0], o[j][1]);
    if (g + 8 < valid)
      *reinterpret_cast<uint32_t*>(out + (g + 8) * rs + 8 * j + d) =
          pack_bf16(o[j][2], o[j][3]);
  }
}

// q, k, v and y of every (image, head): image i, head h, token t at
// base + i * bs + t * rs + 64 h (elements)
struct AttnIO {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* y;
  long long q_bs, k_bs, v_bs, y_bs;
  int q_rs, k_rs, v_rs, y_rs;
};

// the slab's 16 query rows (row pitch rs) as the A fragments of Q . K^T
// (k step kd: rows g and g + 8, columns 16 kd + 2 (lane % 4) and + 8),
// read from device memory; rows >= valid are zeros. L2: through L2 (q
// written earlier in the same launch, K7), else the read-only path
template <bool L2 = false>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[4][4],
                                             const __nv_bfloat16* q,
                                             size_t rs, int valid) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(q + g * rs + c);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(q + (g + 8) * rs + c);
  const bool ok0 = g < valid, ok1 = g + 8 < valid;
  const auto ld = [](const uint32_t* p) { return L2 ? __ldcg(p) : __ldg(p); };
#pragma unroll
  for (int kd = 0; kd < 4; ++kd) {
    qa[kd][0] = ok0 ? ld(r0 + 8 * kd) : 0u;
    qa[kd][1] = ok1 ? ld(r1 + 8 * kd) : 0u;
    qa[kd][2] = ok0 ? ld(r0 + 8 * kd + 4) : 0u;
    qa[kd][3] = ok1 ? ld(r1 + 8 * kd + 4) : 0u;
  }
}

// One block per (head, image), MODE as attention_slab's. K and V of the
// head's N keys are loaded once into swizzled shared memory (256 bytes a
// row for rows up to the last chunk's start + 272), one cp.async group per
// key chunk and one for V, so the first slabs' scores start as soon as
// their chunk lands and V lands during the softmax. The block's warps
// (min(4, np / 16): the launch gives no warp an all-padding slab) walk the
// np / 16 slabs of 16 query rows; a warp reads its Q fragments straight
// from device memory into registers. __launch_bounds__(128, 2): up to 255
// registers a thread (136 of them the scores), two blocks per SM up to N =
// 352 (by shared memory), one above.
template <int MODE, bool SINGLE>
__global__ void __launch_bounds__(128, 2)
    attention_mma(const AttnIO io, const AttnGeom gm, int N, int kv_valid,
                  float c) {
  extern __shared__ __align__(128) unsigned char attn_mma_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(attn_mma_smem);
  __nv_bfloat16* Vs = Ks + gm.rows * AM_D;

  const int head = blockIdx.x;
  const long long img = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const __nv_bfloat16* q = io.q + img * io.q_bs + head * AM_D;
  const __nv_bfloat16* k = io.k + img * io.k_bs + head * AM_D;
  const __nv_bfloat16* v = io.v + img * io.v_bs + head * AM_D;
  __nv_bfloat16* y = io.y + img * io.y_bs + head * AM_D;

  // one group per key chunk (the last also zero-fills the rows past np),
  // then V
  for (int ch = 0; ch < gm.nchunks; ++ch) {
    const int k0 = ch * gm.kc;
    load_rows_sw(Ks, k, io.k_rs, N, k0,
                 ch + 1 < gm.nchunks ? k0 + gm.kc : gm.rows, tid, blockDim.x);
    cp_async_commit();
  }
  load_rows_sw(Vs, v, io.v_rs, N, 0, gm.rows, tid, blockDim.x);
  cp_async_commit();

  // the wrapper gives the block at most np / 16 warps: each has a slab in
  // the first round, which waits for the chunks with block barriers
  for (int sl = warp; sl < gm.np / 16; sl += nwarps) {
    const int row = sl * 16;
    uint32_t qa[4][4];
    load_q_frags(qa, q + static_cast<size_t>(row) * io.q_rs, io.q_rs,
                 N - row);
    float o[8][4];
    attention_slab<MODE, SINGLE>(qa, Ks, Vs, gm, kv_valid, c, sl == warp, o);
    store_slab(o, y + static_cast<size_t>(row) * io.y_rs, io.y_rs, N - row);
  }
}

// the launch of attention_mma with the geometry of
// ops/attention.py::attention_geometry: key chunks of kc keys, nchunks of
// them over np; rows of K and V in shared memory; threads a block (32 to
// 128); smem dynamic shared-memory bytes; c = scale log2(e)
template <int MODE>
cudaError_t launch_attention_mma(const AttnIO& io, int images, int heads,
                                 int N, int kv_valid, float scale,
                                 const AttnGeom& gm, int threads, int smem,
                                 cudaStream_t stream) {
  // one kernel for rows of one chunk, one for the two-pass rows
  const auto kernel = gm.nchunks == 1 ? attention_mma<MODE, true>
                                      : attention_mma<MODE, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, images), threads, smem, stream>>>(io, gm, N, kv_valid,
                                                        scale * AM_LOG2E);
  return cudaGetLastError();
}

}  // namespace
