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
//       projection inside, q, k, v = bf16(bf16(x . W) + b), then K8b.
// The TPU kernels pack two heads into one 128-lane contraction (their +/-
// trick) to fill the TPU's matrix unit; here each warp computes one head's
// scores directly as q . k^T on the tensor cores (wmma 16x16x16).
//
// K8a and K8b: one block per (64 query rows, head, image), K5's shape
// (vit.cuh): K, V of all N keys and the tile's Q in shared memory (93,696
// bytes at N = 257, two blocks per SM); each warp takes 16 query rows
// through two passes over the keys, the scores recomputed in each
// (slab_max_sum: the row max and sum, online; slab_exact: p . V). K8a's f32
// p goes through the bf16 tensor cores as bf16(p) + bf16(p - bf16(p)), two
// products against the exact bf16 V: p to ~2^-16 of itself, as the TPU
// kernel's f32 dot.
//
// K8c: one block of 8 warps per (head, image). The prologue computes the
// head's q, k and v for all N tokens (a [Np, C] x [C, 192] product: 64-row
// tiles of x and 32-deep slices of the head's 192 weight columns in a
// two-stage cp.async pipeline, wmma) into shared memory (3 x 272 x 72 x 2
// = 117,504 bytes at N = 257), so the [B, N, 3C] tensor never reaches
// device memory; the warps then walk the 16-row query slabs. 165,632 bytes
// of shared memory: one block per SM.
//
// What bounds them on an H100: at ViT-B/14 and B = 128, K8a/K8b do 26.0
// GFLOP on 202 MB (bytes: 0.060 ms at 3.35 TB/s) and K8c 142.4 GFLOP on
// 105 MB (operations: 0.144 ms at 989 TFLOP/s). This first version
// recomputes q . k^T per pass (K8a also doubles the value products), on
// mma.sync through wmma; wgmma and TMA are later work.

#include "vit.cuh"

namespace {

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

template <bool SPLIT>
__global__ void __launch_bounds__(AT_THREADS, 2)
    attention_exact(const AttnIO io, int N, int kv_valid, float scale) {
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
  const long long img = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const __nv_bfloat16* q = io.q + img * io.q_bs + head * HD;
  const __nv_bfloat16* k = io.k + img * io.k_bs + head * HD;
  const __nv_bfloat16* v = io.v + img * io.v_bs + head * HD;

  // K and Q in one cp.async group (pass 1 needs them), V in a second
  load_head_rows(Ks, k, io.k_rs, N, np, tid, AT_THREADS);
  load_head_rows(Qs, q + static_cast<size_t>(q0) * io.q_rs, io.q_rs, N - q0,
                 AT_BQ, tid, AT_THREADS);
  cp_async_commit();
  load_head_rows(Vs, v, io.v_rs, N, np, tid, AT_THREADS);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  QFrag qf[HD / 16];
  load_q(qf, Qs + warp * 16 * KV_LD);
  float* st = s_tiles + warp * 256;
  __nv_bfloat16* pt = p_tiles + warp * 256;
  float m, z;
  slab_max_sum(qf, Ks, np, kv_valid, scale, st, m, z);

  cp_async_wait<0>();
  __syncthreads();

  AccFrag o[HD / 16];
  slab_exact<SPLIT>(qf, Ks, Vs, np, kv_valid, scale, m, z, st, pt, o);
  const int row = q0 + warp * 16;
  slab_store(o, 1.0f, st,
             io.y + img * io.y_bs + static_cast<size_t>(row) * io.y_rs +
                 head * HD,
             io.y_rs, N - row);
}

template <bool SPLIT>
cudaError_t launch_attention_exact(const AttnIO& io, int images, int heads,
                                   int N, int kv_valid, float scale,
                                   cudaStream_t s) {
  const size_t smem = attention_smem((N + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(
      attention_exact<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + AT_BQ - 1) / AT_BQ, heads, images);
  attention_exact<SPLIT><<<grid, AT_THREADS, smem, s>>>(io, N, kv_valid,
                                                        scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K8c

constexpr int QA_THREADS = 256;
constexpr int QA_WARPS = QA_THREADS / 32;
constexpr int QA_BM = 64;           // token rows per projection tile
constexpr int QA_BN = 3 * HD;       // the head's q | k | v columns
constexpr int QA_LDB = QA_BN + 8;   // bf16 pitch of the weight slices

size_t qkv_attention_smem(int np) {
  return 3 * static_cast<size_t>(np) * KV_LD * 2  // Q, K, V
         + 2 * QA_BM * A_LD * 2                   // x tiles, two stages
         + 2 * BK * QA_LDB * 2                    // W slices, two stages
         + QA_WARPS * 16 * 16 * (4 + 2);          // s, p tiles
}

__global__ void __launch_bounds__(QA_THREADS, 1)
    qkv_attention(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ b,
                  __nv_bfloat16* __restrict__ y, int N, int C, int kv_valid,
                  float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int np = (N + 15) & ~15;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + np * KV_LD;
  __nv_bfloat16* Vs = Ks + np * KV_LD;
  __nv_bfloat16* As = Vs + np * KV_LD;     // [2][QA_BM][A_LD]
  __nv_bfloat16* Bs = As + 2 * QA_BM * A_LD;  // [2][BK][QA_LDB]
  float* s_tiles = reinterpret_cast<float*>(Bs + 2 * BK * QA_LDB);
  __nv_bfloat16* p_tiles =
      reinterpret_cast<__nv_bfloat16*>(s_tiles + QA_WARPS * 256);

  const int head = blockIdx.x;
  const int img = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
  float* st = s_tiles + warp * 256;
  __nv_bfloat16* pt = p_tiles + warp * 256;
  const __nv_bfloat16* xi = x + static_cast<size_t>(img) * N * C;
  const size_t ldw = 3 * static_cast<size_t>(C);

  // prologue: q | k | v = bf16(bf16(x . W[:, cols]) + b[cols]) for every
  // token, the head's columns c of 192 being W's (c / 64) C + 64 head +
  // c % 64; a warp owns 16 rows x 96 columns of each 64 x 192 tile
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 96;
  const int ktiles = C / BK;
  for (int r0 = 0; r0 < np; r0 += QA_BM) {
    auto load_tile = [&](int kt, int stage) {
      const int k0 = kt * BK;
      __nv_bfloat16* as = As + stage * QA_BM * A_LD;
      __nv_bfloat16* bs = Bs + stage * BK * QA_LDB;
      {  // x: 64 rows x 4 vectors of 8, one per thread
        const int row = tid >> 2;
        const int col = (tid & 3) * 8;
        const bool ok = r0 + row < N;
        cp_async16(as + row * A_LD + col,
                   ok ? xi + static_cast<size_t>(r0 + row) * C + k0 + col
                      : xi,
                   ok);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {  // W: 32 rows x 24 vectors
        const int vv = tid + i * QA_THREADS;
        const int row = vv / 24;
        const int c = (vv % 24) * 8;
        cp_async16(bs + row * QA_LDB + c,
                   w + static_cast<size_t>(k0 + row) * ldw + (c / HD) * C +
                       head * HD + c % HD,
                   true);
      }
    };

    AccFrag acc[6];
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) wmma::fill_fragment(acc[jj], 0.0f);
    load_tile(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // tile kt has landed
      __syncthreads();
      const __nv_bfloat16* as = As + (kt & 1) * QA_BM * A_LD;
      const __nv_bfloat16* bs = Bs + (kt & 1) * BK * QA_LDB;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(af, as + wr * A_LD + kk, A_LD);
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf;
          wmma::load_matrix_sync(bf, bs + kk * QA_LDB + wc + jj * 16, QA_LDB);
          wmma::mma_sync(acc[jj], af, bf, acc[jj]);
        }
      }
      __syncthreads();  // the next iteration overwrites this stage
    }
    // epilogue through the warp's s tile: padded rows get zeros
    const int row = r0 + wr + r;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) {
      wmma::store_matrix_sync(st, acc[jj], 16, wmma::mem_row_major);
      __syncwarp();
      const int c = wc + jj * 16 + c8;
      const int which = c / HD;
      const int cc = c % HD;
      float f[8];
      if (row < N) {
        float bf[8];
        unpack8(*reinterpret_cast<const uint4*>(b + which * C + head * HD +
                                                 cc),
                bf);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = __bfloat162float(__float2bfloat16(st[r * 16 + c8 + e])) +
                 bf[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.0f;
      }
      if (row < np) {
        __nv_bfloat16* dst = which == 0 ? Qs : which == 1 ? Ks : Vs;
        *reinterpret_cast<uint4*>(dst + row * KV_LD + cc) = pack8(f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // attention: the warps walk the 16-row query slabs
  for (int sl = warp; sl < np / 16; sl += QA_WARPS) {
    QFrag qf[HD / 16];
    load_q(qf, Qs + sl * 16 * KV_LD);
    float m, z;
    slab_max_sum(qf, Ks, np, kv_valid, scale, st, m, z);
    AccFrag o[HD / 16];
    slab_exact<false>(qf, Ks, Vs, np, kv_valid, scale, m, z, st, pt, o);
    slab_store(o, 1.0f, st,
               y + (static_cast<size_t>(img) * N + sl * 16) * C + head * HD,
               C, N - sl * 16);
  }
}

}  // namespace

// Shapes, strides and alignment are checked by the Python wrappers
// (multimodal_baby_tpu_torch/ops/attention.py): bf16, heads of 64, 1 <=
// kv_valid <= N <= 752 (K8c: 416, and C % 32 == 0), every pointer and
// stride 16-byte aligned, the last axis contiguous. Strides are in
// elements; split = 1 keeps p at f32 grade (K8a). Returns the first CUDA
// error, or 0.
extern "C" int mmb_attention_bf16(const void* q, const void* k, const void* v,
                                  void* y, long long q_bs, long long k_bs,
                                  long long v_bs, long long y_bs, int q_rs,
                                  int k_rs, int v_rs, int y_rs, int images,
                                  int heads, int N, int kv_valid, float scale,
                                  int split, void* stream) {
  const AttnIO io{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v),
                  static_cast<__nv_bfloat16*>(y),
                  q_bs, k_bs, v_bs, y_bs, q_rs, k_rs, v_rs, y_rs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      split ? launch_attention_exact<true>(io, images, heads, N, kv_valid,
                                           scale, s)
            : launch_attention_exact<false>(io, images, heads, N, kv_valid,
                                            scale, s));
}

// x [B, N, C], w [C, 3C] (columns (q | k | v) x (head, feature)), b [3C],
// y [B, N, C]
extern "C" int mmb_qkv_attention_bf16(const void* x, const void* w,
                                      const void* b, void* y, int B, int N,
                                      int C, int kv_valid, float scale,
                                      void* stream) {
  const size_t smem = qkv_attention_smem((N + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(C / HD, B);
  qkv_attention<<<grid, QA_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
      N, C, kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}
