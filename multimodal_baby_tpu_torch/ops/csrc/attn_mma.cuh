// The exact-softmax attention core of K8a and K8c (attention.cu) on
// Hopper's warp-level tensor-core product, mma.sync m16n8k16 (bf16 in, f32
// sums), in inline PTX, with fragments loaded by ldmatrix.
//
// One warp owns 16 query rows of one head (a "slab") and holds their
// scores against a chunk of up to AM_CHUNK = 272 keys in registers, in the
// m16n8 accumulator layout: 34 n8 tiles x 4 f32 a thread. A thread holds
// rows g = lane / 4 and g + 8, columns 2 (lane % 4) and + 1 of each tile,
// so a row's max and sum take two quad shuffles (xor 1, xor 2). Two n8
// tiles of p are one k16 A fragment of the value product: p goes from the
// accumulators into the P . V operands without touching shared memory.
//
// The softmax is the TPU kernels' exact one, p = exp(s scale - max) / sum,
// divided before the value contraction, with two rewrites that move p by a
// few ulp (tests/test_torch_attention_order.py emulates them on the CPU and
// holds them to the JAX kernels): exp(s scale - m) is computed as
// 2^(s c - m') with c = scale * log2(e) folded into the score (m' the max
// of s c) on the special-function unit (ex2.approx), and p = e * (1 / z)
// with one reciprocal per row. Keys >=
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

#pragma once

#include "gemm.cuh"

namespace {

constexpr int AM_D = 64;          // head width
constexpr int AM_CHUNK = 272;     // keys whose scores a warp holds at once
constexpr int AM_NT = AM_CHUNK / 8;  // n8 score tiles: 136 f32 registers
constexpr float AM_LOG2E = 1.44269504088896341f;

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
// geometry, keys >= kv_valid masked (kv_valid >= 1), c = scale log2(e).
// SINGLE: the geometry has one chunk (np <= 272), compiled apart from the
// two-pass code so that neither pays the other's registers.
// first: the block's first round, whose K chunks and V are still landing
// (one cp.async group per K chunk, then one for V): each chunk is waited
// for, with a block barrier, just before its scores, and V before the
// first value product. Every warp of the block must take part in it.
template <bool SPLIT, bool SINGLE>
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
  if constexpr (SINGLE) {
#pragma unroll
    for (int t = 0; t < AM_NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] *= rz[e >> 1];
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
        for (int e = 0; e < 4; ++e)
          s[t][e] = ex2(s[t][e] - m[e >> 1]) * rz[e >> 1];
      }
      chunk_pv<SPLIT>(s, Vs, k0, o);
    }
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

}  // namespace
