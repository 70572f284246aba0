// The two halves of a pre-norm ViT block on Hopper (sm_90a), bf16 in and
// out, f32 accumulation:
//
//   K5  out = bf16(x + (attn(qkv(LN1(x))) . Wproj) + bproj)
//   K6  out = bf16(x + (gelu(LN2(x) . W1 + b1) . W2) + b2)
//
// Replace the TPU kernels multimodal_baby_tpu/ops/attention.py::
// fused_block_attention (body `_attn_half_f32`) and ops/vit_mlp.py::
// fused_mlp (body `_mlp_half_f32`), which run one image per program with
// every intermediate in VMEM. Rounding points follow those bodies:
//   - LayerNorm statistics in f32 with var = E[x^2] - mean^2; xn rounded to
//     bf16; gamma and beta arrive in bf16;
//   - q, k, v = bf16(bf16(xn . Wqkv) + bqkv): the product is rounded, then
//     the bf16 bias is added and the sum rounded again;
//   - scores s = (q . k) * scale in f32; key columns >= kv_valid get no
//     weight (the TPU kernel adds -1e9, whose exp is exactly 0);
//   - deferred softmax: p = exp(s - max) in f32, z = sum(p) from the
//     unrounded p, p rounded to bf16, y = bf16((p . v) * (1 / z));
//   - h = xn . W1 + b1 stays f32 into the erf GELU (CUDA erff; the TPU kernel
//     uses a rational erfc because Mosaic has no erf), rounded once;
//   - the residual sums x_f32 + acc_f32 + bias and rounds once.
//
// What bounds it on an H100: at ViT-B/14 (C = 768, N = 257, 12 heads of
// 64, F = 3072) K5 does ~1,700 and K6 ~2,800 FLOPs per byte of its input,
// weights and output, so both are bound by tensor-core throughput (the
// card's balance point is ~295 FLOPs per byte). This first version is
// four launches per half: a LayerNorm (one warp per token row), and GEMMs
// on the tensor cores (gemm.cuh) with fused epilogues; K5 adds an attention
// kernel between its two GEMMs. xn, qkv, y and the [M, F] hidden pass
// through device memory in bf16. Keeping them on chip (one persistent
// launch per half, wgmma and TMA) is later work.

#include "gemm.cuh"

#include <math.h>

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- LayerNorm

constexpr int LN_ROWS = 8;  // rows (warps) per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[m] = bf16(((x[m] - mean) * rsqrt(var + eps)) * g + b); C % 8 == 0
__global__ void __launch_bounds__(LN_ROWS * 32)
    layer_norm_bf16(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, int M, int C,
                    float eps) {
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * C;
  __nv_bfloat16* orow = out + static_cast<size_t>(row) * C;
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += f[e];
      s2 += f[e] * f[e];
    }
  }
  const float mean = warp_sum(s) / C;
  const float var = warp_sum(s2) / C - mean * mean;
  const float rstd = rsqrtf(var + eps);
  for (int c = lane * 8; c < C; c += 256) {
    float f[8], gf[8], bf[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
    unpack8(*reinterpret_cast<const uint4*>(g + c), gf);
    unpack8(*reinterpret_cast<const uint4*>(b + c), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = ((f[e] - mean) * rstd) * gf[e] + bf[e];
    *reinterpret_cast<uint4*>(orow + c) = pack8(f);
  }
}

cudaError_t launch_layer_norm(const void* x, const void* g, const void* b,
                              void* out, int M, int C, float eps,
                              cudaStream_t s) {
  layer_norm_bf16<<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      M, C, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------ GEMM epilogues

// qkv: out = bf16(bf16(acc) + bias), two roundings as nn.Dense in bf16
struct RoundThenBias {
  const __nv_bfloat16* bias;  // [N] bf16
  __nv_bfloat16* out;         // [M, N]
  int N;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    float bf[8];
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __bfloat162float(__float2bfloat16(v[e])) + bf[e];
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) =
        pack8(v);
  }
};

// proj and fc2: out = bf16((residual + acc) + bias), one rounding
struct ResidualBias {
  const __nv_bfloat16* residual;  // [M, N]
  const __nv_bfloat16* bias;      // [N] bf16
  __nv_bfloat16* out;             // [M, N]
  int N;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    const size_t off = static_cast<size_t>(m) * N + n;
    float rf[8], bf[8];
    unpack8(*reinterpret_cast<const uint4*>(residual + off), rf);
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (rf[e] + v[e]) + bf[e];
    *reinterpret_cast<uint4*>(out + off) = pack8(v);
  }
};

// fc1: out = bf16(gelu_erf(acc + bias)), the sum kept in f32
struct BiasGelu {
  const __nv_bfloat16* bias;  // [N] bf16
  __nv_bfloat16* out;         // [M, N]
  int N;

  __device__ void operator()(int m, int n, float (&v)[8]) const {
    float bf[8];
    unpack8(*reinterpret_cast<const uint4*>(bias + n), bf);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = v[e] + bf[e];
      v[e] = 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) =
        pack8(v);
  }
};

GemmArgs dense(const void* a, const void* w, int M, int K, int N) {
  GemmArgs g{};
  g.a1 = static_cast<const __nv_bfloat16*>(a);
  g.b1 = static_cast<const __nv_bfloat16*>(w);
  g.k1 = K;
  g.M = M;
  g.N = N;
  return g;
}

// ---------------------------------------------------------------- attention

// One block per (query tile of 64 rows, head, image). The head's K and V
// for all N tokens (rows padded to NP = N rounded up to 16, zero-filled)
// and the tile's Q sit in shared memory: 93,696 bytes at N = 257, so two
// blocks share an SM. Each of the 4 warps owns 16 query rows and walks the
// keys 16 at a time, twice:
//   pass 1: s = (Q . K_j^T) * scale on the tensor cores -> the row max;
//   pass 2: s again -> p = exp(s - max) in f32, summed into z, rounded to
//           bf16 -> o += p . V_j on the tensor cores.
// Computing Q . K^T twice (a quarter of the kernel's products) keeps the
// [64, N] scores and probabilities out of shared memory; every value is
// the same as with the scores kept. V loads while pass 1 runs.
constexpr int HD = 64;          // head dim
constexpr int AT_BQ = 64;       // query rows per block
constexpr int AT_THREADS = 128;
constexpr int KV_LD = HD + 8;   // bf16 pitch of K, V and Q

// the 227 KB a block may use caps N at 752
size_t attention_smem(int np) {
  return (2 * static_cast<size_t>(np) + AT_BQ) * KV_LD * 2  // K, V, Q
         + AT_THREADS / 32 * 16 * 16 * (4 + 2);             // s, p tiles
}

__global__ void __launch_bounds__(AT_THREADS, 2)
    attention_bf16(const __nv_bfloat16* __restrict__ qkv,
                   __nv_bfloat16* __restrict__ y, int N, int C, int kv_valid,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int np = (N + 15) & ~15;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + np * KV_LD;
  __nv_bfloat16* Qs = Vs + np * KV_LD;
  float* s_tiles = reinterpret_cast<float*>(Qs + AT_BQ * KV_LD);
  __nv_bfloat16* p_tiles =
      reinterpret_cast<__nv_bfloat16*>(s_tiles + AT_THREADS / 32 * 256);

  const int q0 = blockIdx.x * AT_BQ;
  const int head = blockIdx.y;
  const int img = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t ld3 = 3 * static_cast<size_t>(C);
  // q of token t, head h at base[t * 3C]; k at + C; v at + 2C
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(img) * N * ld3 + head * HD;

  // K and Q in one cp.async group (pass 1 needs them), V in a second
  for (int v = tid; v < np * 8; v += AT_THREADS) {
    const int row = v >> 3;
    const int col = (v & 7) * 8;
    const bool ok = row < N;
    cp_async16(Ks + row * KV_LD + col, (ok ? base + row * ld3 : base) + C + col,
               ok);
  }
  for (int v = tid; v < AT_BQ * 8; v += AT_THREADS) {
    const int row = v >> 3;
    const int col = (v & 7) * 8;
    const bool ok = q0 + row < N;
    cp_async16(Qs + row * KV_LD + col,
               (ok ? base + (q0 + row) * ld3 : base) + col, ok);
  }
  cp_async_commit();
  for (int v = tid; v < np * 8; v += AT_THREADS) {
    const int row = v >> 3;
    const int col = (v & 7) * 8;
    const bool ok = row < N;
    cp_async16(Vs + row * KV_LD + col,
               (ok ? base + row * ld3 : base) + 2 * C + col, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();  // K and Q have landed
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * KV_LD + kk * 16, KV_LD);

  // the warp's 16 x 16 tiles; a lane owns 8 columns of one row
  float* st = s_tiles + warp * 256;
  __nv_bfloat16* pt = p_tiles + warp * 256;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;

  // st = (Q . K_j^T) for this warp's rows and keys 16j .. 16j + 15
  auto scores = [&](int j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // K^T as a column-major 16x16 tile: (d, key) at Ks[key][d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          kf;
      wmma::load_matrix_sync(kf, Ks + j * 16 * KV_LD + kk * 16, KV_LD);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
  };

  // pass 1: the row max over the valid keys
  float m = -INFINITY;
  for (int j = 0; j < np / 16; ++j) {
    scores(j);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j * 16 + c8 + e < kv_valid) m = fmaxf(m, st[r * 16 + c8 + e] * scale);
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // pass 2: p = exp(s - max), z = sum(p), o += bf16(p) . V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  float z = 0.0f;
  for (int j = 0; j < np / 16; ++j) {
    scores(j);
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = j * 16 + c8 + e < kv_valid
                 ? expf(st[r * 16 + c8 + e] * scale - m)
                 : 0.0f;
      z += p[e];
    }
    *reinterpret_cast<uint4*>(pt + r * 16 + c8) = pack8(p);
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        pf;
    wmma::load_matrix_sync(pf, pt, 16);
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          vf;
      wmma::load_matrix_sync(vf, Vs + j * 16 * KV_LD + jj * 16, KV_LD);
      wmma::mma_sync(o[jj], pf, vf, o[jj]);
    }
    __syncwarp();  // the next tile overwrites st and pt
  }
  const float zi = 1.0f / (z + __shfl_xor_sync(0xffffffffu, z, 1));

  // y = bf16(o * (1 / z)), each 16 x 16 tile through the warp's s tile
  const int q = q0 + warp * 16 + r;
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    wmma::store_matrix_sync(st, o[jj], 16, wmma::mem_row_major);
    __syncwarp();
    if (q < N) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = st[r * 16 + c8 + e] * zi;
      *reinterpret_cast<uint4*>(y + (static_cast<size_t>(img) * N + q) * C +
                                head * HD + jj * 16 + c8) = pack8(f);
    }
    __syncwarp();
  }
}

cudaError_t launch_attention(const void* qkv, void* y, int B, int N, int C,
                             int kv_valid, float scale, cudaStream_t s) {
  const size_t smem = attention_smem((N + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + AT_BQ - 1) / AT_BQ, C / HD, B);
  attention_bf16<<<grid, AT_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(y),
      N, C, kv_valid, scale);
  return cudaGetLastError();
}

}  // namespace

// Shapes and alignment are checked by the Python wrappers
// (multimodal_baby_tpu_torch/ops/attention.py and ops/vit_mlp.py): bf16
// everywhere, C % 128 == 0, heads of 64, F % 128 == 0, 1 <= kv_valid <= N
// <= 752, every pointer 16-byte aligned. Weights are [in, out] row-major.
// xn [B*N, C], qkv [B*N, 3C], y [B*N, C] and h [M, F] are scratch.
// Each returns the first CUDA error, or 0.
extern "C" int mmb_vit_attention_bf16(const void* x, const void* ln_g,
                                      const void* ln_b, const void* wqkv,
                                      const void* bqkv, const void* wproj,
                                      const void* bproj, void* xn, void* qkv,
                                      void* y, void* out, int B, int N, int C,
                                      int kv_valid, float scale, float eps,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = launch_layer_norm(x, ln_g, ln_b, xn, M, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RoundThenBias e_qkv{static_cast<const __nv_bfloat16*>(bqkv),
                            static_cast<__nv_bfloat16*>(qkv), 3 * C};
  err = launch_gemm(dense(xn, wqkv, M, C, 3 * C), e_qkv, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_attention(qkv, y, B, N, C, kv_valid, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ResidualBias e_proj{static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(bproj),
                            static_cast<__nv_bfloat16*>(out), C};
  return static_cast<int>(launch_gemm(dense(y, wproj, M, C, C), e_proj, s));
}

extern "C" int mmb_vit_mlp_bf16(const void* x, const void* ln_g,
                                const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* xn, void* h, void* out, int M, int C,
                                int F, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layer_norm(x, ln_g, ln_b, xn, M, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BiasGelu e1{static_cast<const __nv_bfloat16*>(b1),
                    static_cast<__nv_bfloat16*>(h), F};
  err = launch_gemm(dense(xn, w1, M, C, F), e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ResidualBias e2{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(b2),
                        static_cast<__nv_bfloat16*>(out), C};
  return static_cast<int>(launch_gemm(dense(h, w2, M, F, C), e2, s));
}
