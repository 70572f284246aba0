// The fused symmetric InfoNCE (K4) on Hopper (sm_90a), forward and
// backward, f32 throughout (FMA, no TF32). With s = exp(neg_log_temp) and
// logits l = s img . txt^T [B, B]:
//
//   forward:  lse_i (rows), lse_t (columns), the loss
//             (sum_i (lse_i[i] - l_ii) + sum_j (lse_t[j] - l_jj)) / 2B, and
//             the metrics: accuracies (l_ii >= its row / column max, ties
//             count) and entropies (sum p (lse - l)), means over B.
//   backward: D = g ((P_row - I) + (P_col - I)) / 2B with P rebuilt from the
//             saved LSEs; d_img = s D . txt, d_txt = s D^T . img,
//             d(neg_log_temp) = sum D * l.
//
// Replaces the TPU kernels multimodal_baby_tpu/ops/infonce.py::
// fused_infonce_with_metrics (`_fwd_kernel`, `_bwd_kernel`), which hold the
// whole B x B block in VMEM (4 MB at B = 1024). An SM has 227 KB, so each
// pass is one persistent cooperative launch (grid.cuh) over 64 x 64 tiles
// of the logits, recomputed from img and txt in each pass:
//   forward  1: each tile's row and column statistics (max, sum e^(l-max),
//               sum e^(l-max) (l-max): the entropy needs no second pass) and
//               the diagonal, into scratch; grid barrier;
//            2: block 0 merges the statistics of each row and column tile
//               by tile in a fixed order and reduces the sums in a fixed
//               tree: no float atomics, a repeated call gives the same bits.
//   backward 1: each tile's D into scratch [B, B] and its sum D * l;
//               grid barrier;
//            2: d_img and d_txt as 64 x 64 output tiles of D . txt and
//               D^T . img (K = B); block 0 sums the tiles' D * l in order.
// Every operand read goes through L2 (__ldcg): D is written before the
// barrier by other blocks.
//
// What bounds it on an H100: the f32 FMA rate at B = 1024, E = 512
// (forward 1.07 GFLOP, 0.016 ms at 67 TFLOP/s; backward 3.2 GFLOP,
// 0.048 ms); at B = 128 the launch and the barrier.

#include <math.h>

#include "grid.cuh"

namespace {

constexpr int NT_THREADS = 256;
constexpr int T64 = 64;  // output tile
constexpr int TK = 16;   // K step
constexpr int T_LD = T64 + 4;

struct Smem {
  float a[TK][T_LD];  // [k][m]
  float b[TK][T_LD];  // [k][n]
  float l[T64][T64 + 1];
  float red[6][NT_THREADS];
};

// An operand's element (m, k): `kmajor` false: src[m * ld + k] (K
// contiguous); true: src[k * ld + m] (M contiguous). Fills dst[k][m] for
// m0 <= m < m0 + 64, k0 <= k < k0 + TK; zeros past M or K (both multiples
// of 4).
__device__ __forceinline__ void load_operand(float (*dst)[T_LD],
                                             const float* src, int ld,
                                             bool kmajor, int m0, int M,
                                             int k0, int K) {
  const int t = threadIdx.x;
  if (!kmajor) {
    const int m = t % T64;
    const int kq = (t / T64) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + m < M && k0 + kq < K)
      v = __ldcg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(m0 + m) * ld + k0 + kq));
    dst[kq][m] = v.x;
    dst[kq + 1][m] = v.y;
    dst[kq + 2][m] = v.z;
    dst[kq + 3][m] = v.w;
  } else {
    const int k = t / (T64 / 4);
    const int m = (t % (T64 / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + m < M && k0 + k < K)
      v = __ldcg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(k0 + k) * ld + m0 + m));
    *reinterpret_cast<float4*>(&dst[k][m]) = v;
  }
}

// acc[i][j] = sum_k A(m0 + 4 ty + i, k) B(n0 + 4 tx + j, k) over k < K
__device__ __forceinline__ void tile_product(
    float (&acc)[4][4], const float* A, int lda, bool a_kmajor, int m0, int M,
    const float* Bp, int ldb, bool b_kmajor, int n0, int N, int K, Smem& s) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += TK) {
    __syncthreads();
    load_operand(s.a, A, lda, a_kmajor, m0, M, k0, K);
    load_operand(s.b, Bp, ldb, b_kmajor, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The block's sum of one value per thread, in a fixed tree; valid in
// thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int n = NT_THREADS / 2; n > 0; n >>= 1) {
    if (static_cast<int>(threadIdx.x) < n)
      red[threadIdx.x] += red[threadIdx.x + n];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// (max, sum e^(l - max), sum e^(l - max) (l - max)) of a run of logits
struct Stats {
  float m, s, w;
};

__device__ __forceinline__ Stats merge(const Stats a, const Stats b) {
  const float m = fmaxf(a.m, b.m);
  const float ea = expf(a.m - m);
  const float eb = expf(b.m - m);
  return {m, a.s * ea + b.s * eb,
          ea * (a.w + (a.m - m) * a.s) + eb * (b.w + (b.m - m) * b.s)};
}

struct FwdArgs {
  const float *img, *txt, *nlt;
  float* part;  // row then column stats: 6 arrays of [tiles][B]; diag [B]
  float *loss, *lse_i, *lse_t, *metrics;
  unsigned* bar;
  int B, E;
};

__global__ void __launch_bounds__(NT_THREADS)
    infonce_fwd_kernel(const FwdArgs p) {
  __shared__ __align__(16) Smem s;
  const int B = p.B;
  const int nt = (B + T64 - 1) / T64;
  const size_t plane = static_cast<size_t>(nt) * B;
  float* diag = p.part + 6 * plane;
  const float scale = expf(__ldg(p.nlt));
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int tile = blockIdx.x; tile < nt * nt; tile += gridDim.x) {
    const int bi = tile / nt;
    const int bj = tile % nt;
    float acc[4][4];
    tile_product(acc, p.img, p.E, false, bi * T64, B, p.txt, p.E, false,
                 bj * T64, B, p.E, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.l[ty * 4 + i][tx * 4 + j] = scale * acc[i][j];
    __syncthreads();
    const int rows = min(T64, B - bi * T64);
    const int cols = min(T64, B - bj * T64);
    if (tid < 2 * T64) {
      // threads 0-63: the tile's rows; 64-127: its columns
      const bool col = tid >= T64;
      const int r = tid % T64;
      const int n = col ? rows : cols;
      if (r < (col ? cols : rows)) {
        float m = -INFINITY;
        for (int c = 0; c < n; ++c) m = fmaxf(m, col ? s.l[c][r] : s.l[r][c]);
        float sum = 0.0f, w = 0.0f;
        for (int c = 0; c < n; ++c) {
          const float d = (col ? s.l[c][r] : s.l[r][c]) - m;
          const float e = expf(d);
          sum += e;
          w = fmaf(e, d, w);
        }
        const size_t at = (col ? 3 * plane + static_cast<size_t>(bi) * B +
                                     bj * T64
                               : static_cast<size_t>(bj) * B + bi * T64) +
                          r;
        p.part[at] = m;
        p.part[at + plane] = sum;
        p.part[at + 2 * plane] = w;
      }
    } else if (bi == bj && tid - 2 * T64 < rows) {
      const int d = tid - 2 * T64;
      diag[bi * T64 + d] = s.l[d][d];
    }
  }
  grid_sync(p.bar);
  if (blockIdx.x != 0) return;

  // block 0: every row's and column's statistics, tile by tile in order
  float acc_v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int side = 0; side < 2; ++side) {
    const float* mp = p.part + 3 * side * plane;
    float* lse = side ? p.lse_t : p.lse_i;
    for (int i = tid; i < B; i += NT_THREADS) {
      Stats st = {__ldcg(mp + i), __ldcg(mp + plane + i),
                  __ldcg(mp + 2 * plane + i)};
      for (int tl = 1; tl < nt; ++tl) {
        const size_t at = static_cast<size_t>(tl) * B + i;
        st = merge(st, {__ldcg(mp + at), __ldcg(mp + plane + at),
                        __ldcg(mp + 2 * plane + at)});
      }
      const float log_s = logf(st.s);
      const float l_ii = __ldcg(diag + i);
      const float lse_v = st.m + log_s;
      lse[i] = lse_v;
      acc_v[side] += lse_v - l_ii;                      // cross-entropy
      acc_v[2 + side] += l_ii >= st.m ? 1.0f : 0.0f;    // accuracy
      acc_v[4 + side] += log_s - st.w / st.s;           // entropy
    }
  }
  float tot[6];
  for (int q = 0; q < 6; ++q) tot[q] = block_sum(acc_v[q], s.red[q]);
  if (tid == 0) {
    p.loss[0] = (tot[0] + tot[1]) / (2.0f * B);
    for (int q = 0; q < 4; ++q) p.metrics[q] = tot[2 + q] / B;
  }
}

struct BwdArgs {
  const float *img, *txt, *nlt, *lse_i, *lse_t, *g;
  float *D, *part;  // D [B, B]; part [tiles]
  float *dimg, *dtxt, *dnlt;
  unsigned* bar;
  int B, E;
};

__global__ void __launch_bounds__(NT_THREADS)
    infonce_bwd_kernel(const BwdArgs p) {
  __shared__ __align__(16) Smem s;
  const int B = p.B;
  const int E = p.E;
  const int nt = (B + T64 - 1) / T64;
  const int ne = (E + T64 - 1) / T64;
  const float scale = expf(__ldg(p.nlt));
  const float coef = __ldg(p.g) / (2.0f * B);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int tile = blockIdx.x; tile < nt * nt; tile += gridDim.x) {
    const int bi = tile / nt;
    const int bj = tile % nt;
    float acc[4][4];
    tile_product(acc, p.img, E, false, bi * T64, B, p.txt, E, false,
                 bj * T64, B, E, s);
    float dl = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = bi * T64 + ty * 4 + i;
      if (r >= B) continue;
      const float li = __ldg(p.lse_i + r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = bj * T64 + tx * 4 + j;
        if (c >= B) continue;
        const float l = scale * acc[i][j];
        const float eye = r == c ? 2.0f : 0.0f;
        const float d =
            coef * ((expf(l - li) + expf(l - __ldg(p.lse_t + c))) - eye);
        p.D[static_cast<size_t>(r) * B + c] = d;
        dl = fmaf(d, l, dl);
      }
    }
    const float tile_dl = block_sum(dl, s.red[0]);
    if (tid == 0) p.part[tile] = tile_dl;
  }
  grid_sync(p.bar);

  if (blockIdx.x == 0) {  // d(neg_log_temp): the tiles' sums in order
    float v = 0.0f;
    for (int t = tid; t < nt * nt; t += NT_THREADS) v += __ldcg(p.part + t);
    const float tot = block_sum(v, s.red[0]);
    if (tid == 0) p.dnlt[0] = tot;
  }
  // d_img tiles, then d_txt tiles: [B, E] each, K = B
  for (int tile = blockIdx.x; tile < 2 * nt * ne; tile += gridDim.x) {
    const bool t_side = tile >= nt * ne;
    const int q = tile % (nt * ne);
    const int m0 = (q / ne) * T64;
    const int n0 = (q % ne) * T64;
    float acc[4][4];
    // d_img[m, n] = sum_k D[m, k] txt[k, n];
    // d_txt[m, n] = sum_k D[k, m] img[k, n]
    tile_product(acc, p.D, B, t_side, m0, B, t_side ? p.img : p.txt, E, true,
                 n0, E, B, s);
    float* out = t_side ? p.dtxt : p.dimg;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= B) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < E) out[static_cast<size_t>(r) * E + c] = scale * acc[i][j];
      }
    }
  }
}

}  // namespace

// Shapes are checked by the Python wrapper (multimodal_baby_tpu_torch/ops/
// infonce.py): f32, contiguous, 16-byte aligned; img, txt [B, E] with
// B % 4 == 0 and E % 4 == 0; nlt, loss scalars; lse_i, lse_t [B]; metrics
// [4]; part scratch of 6 ceil(B/64) B + B floats; bar two zeroed words.
extern "C" int mmb_infonce_fwd_f32(const void* img, const void* txt,
                                   const void* nlt, void* part, void* loss,
                                   void* lse_i, void* lse_t, void* metrics,
                                   void* bar, int B, int E, void* stream) {
  const FwdArgs p{static_cast<const float*>(img),
                  static_cast<const float*>(txt),
                  static_cast<const float*>(nlt),
                  static_cast<float*>(part),
                  static_cast<float*>(loss),
                  static_cast<float*>(lse_i),
                  static_cast<float*>(lse_t),
                  static_cast<float*>(metrics),
                  static_cast<unsigned*>(bar),
                  B,
                  E};
  const int nt = (B + T64 - 1) / T64;
  return static_cast<int>(launch_persistent(
      infonce_fwd_kernel, p, NT_THREADS, 0,
      static_cast<cudaStream_t>(stream), nt * nt));
}

// g the loss's cotangent (a scalar); D [B, B] and part [ceil(B/64)^2]
// scratch; dimg, dtxt [B, E]; dnlt a scalar.
extern "C" int mmb_infonce_bwd_f32(const void* img, const void* txt,
                                   const void* nlt, const void* lse_i,
                                   const void* lse_t, const void* g, void* D,
                                   void* part, void* dimg, void* dtxt,
                                   void* dnlt, void* bar, int B, int E,
                                   void* stream) {
  const BwdArgs p{static_cast<const float*>(img),
                  static_cast<const float*>(txt),
                  static_cast<const float*>(nlt),
                  static_cast<const float*>(lse_i),
                  static_cast<const float*>(lse_t),
                  static_cast<const float*>(g),
                  static_cast<float*>(D),
                  static_cast<float*>(part),
                  static_cast<float*>(dimg),
                  static_cast<float*>(dtxt),
                  static_cast<float*>(dnlt),
                  static_cast<unsigned*>(bar),
                  B,
                  E};
  const int nt = (B + T64 - 1) / T64;
  const int ne = (E + T64 - 1) / T64;
  const int tiles = nt * nt > 2 * nt * ne ? nt * nt : 2 * nt * ne;
  return static_cast<int>(launch_persistent(
      infonce_bwd_kernel, p, NT_THREADS, 0,
      static_cast<cudaStream_t>(stream), tiles));
}
