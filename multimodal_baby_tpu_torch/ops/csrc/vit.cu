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
//   - h = xn . W1 + b1 stays f32 into the GELU (erf by default, CUDA erff;
//     the TPU kernel uses a rational erfc because Mosaic has no erf; or
//     the tanh or sigmoid form), rounded once;
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
// launch per half, wgmma and TMA) is later work. The LayerNorm row, the
// epilogues and the attention slabs are in vit.cuh, shared with K7.

#include "vit.cuh"

namespace {

constexpr int LN_ROWS = 8;  // rows (warps) per LayerNorm block

__global__ void __launch_bounds__(LN_ROWS * 32)
    layer_norm_bf16(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, int M, int C,
                    float eps) {
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  layer_norm_row(x + static_cast<size_t>(row) * C, g, b,
                 out + static_cast<size_t>(row) * C, C, eps);
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

// ---------------------------------------------------------------- attention

// One block per (query tile of 64 rows, head, image). The head's K and V
// for all N tokens (rows padded to NP = N rounded up to 16, zero-filled)
// and the tile's Q sit in shared memory: 93,696 bytes at N = 257, so two
// blocks share an SM. Each of the 4 warps owns 16 query rows and walks the
// keys 16 at a time, twice (vit.cuh's slab_max, then slab_defer):
//   pass 1: s = (Q . K_j^T) * scale on the tensor cores -> the row max;
//   pass 2: s again -> p = exp(s - max) in f32, summed into z, rounded to
//           bf16 -> o += p . V_j on the tensor cores.
// Computing Q . K^T twice (a quarter of the kernel's products) keeps the
// [64, N] scores and probabilities out of shared memory; every value is
// the same as with the scores kept. V loads while pass 1 runs.
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
  const size_t ld3 = 3 * static_cast<size_t>(C);
  // q of token t, head h at base[t * 3C]; k at + C; v at + 2C
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(img) * N * ld3 + head * HD;

  // K and Q in one cp.async group (pass 1 needs them), V in a second
  load_head_rows(Ks, base + C, ld3, N, np, tid, AT_THREADS);
  load_head_rows(Qs, base + q0 * ld3, ld3, N - q0, AT_BQ, tid, AT_THREADS);
  cp_async_commit();
  load_head_rows(Vs, base + 2 * C, ld3, N, np, tid, AT_THREADS);
  cp_async_commit();
  cp_async_wait<1>();  // K and Q have landed
  __syncthreads();

  QFrag qf[HD / 16];
  load_q(qf, Qs + warp * 16 * KV_LD);
  float* st = s_tiles + warp * 256;
  __nv_bfloat16* pt = p_tiles + warp * 256;
  const float m = slab_max(qf, Ks, np, kv_valid, scale, st);

  cp_async_wait<0>();  // V has landed
  __syncthreads();

  AccFrag o[HD / 16];
  const float z = slab_defer(qf, Ks, Vs, np, kv_valid, scale, m, st, pt, o);
  const int q = q0 + warp * 16;
  slab_store(o, 1.0f / z, st,
             y + (static_cast<size_t>(img) * N + q) * C + head * HD, C,
             N - q);
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
// xn [B*N, C], qkv [B*N, 3C], y [B*N, C] and h [M, F] are scratch; gelu is
// a GeluMode. Each returns the first CUDA error, or 0.
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
                                int F, int gelu, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layer_norm(x, ln_g, ln_b, xn, M, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BiasGelu e1{static_cast<const __nv_bfloat16*>(b1),
                    static_cast<__nv_bfloat16*>(h), F, gelu};
  err = launch_gemm(dense(xn, w1, M, C, F), e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ResidualBias e2{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(b2),
                        static_cast<__nv_bfloat16*>(out), C};
  return static_cast<int>(launch_gemm(dense(h, w2, M, F, C), e2, s));
}
