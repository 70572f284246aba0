// The fused symmetric InfoNCE (K4) on Hopper (sm_90a), forward and
// backward: f32 in and out, the products on the tensor cores as three TF32
// products (mma_tf32.cuh). With s = exp(neg_log_temp) and logits
// l = s img . txt^T [B, B]:
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
// whole B x B block in VMEM (4 MB at B = 1024). An SM has 227 KB, so the
// logits are cut into T x T tiles, recomputed from img and txt in each pass.
// Every tile product runs on one engine (`tile_product`): 256 threads, 2 x 4
// warps over a TM x TN output tile, K in 32-deep chunks through a
// cp.async ring of 4 to 8 stages, each element split into TF32 hi and lo as
// its fragment is read, the large and the small products summed apart.
//
// B <= 256: one thread-block cluster of nt x nt blocks (T = 32 to B = 128,
// else 64; nt = ceil(B / T), up to 16 blocks), no grid barrier.
//   forward:  each block its tile's row and column statistics (max,
//             sum e^(l-max), sum e^(l-max) (l-max): the entropy needs no
//             second pass) and diagonal in shared memory; barrier.cluster;
//             block (p, q) merges its share of row tile p's rows and column
//             tile p's columns across the tiles in order, reading its peers'
//             shared memory (DSMEM), and hands its six partial sums to block
//             0, which adds them in rank order after a second barrier.
//   backward: each block its D tile in shared memory and its sum D * l;
//             barrier.cluster; block (p, q) copies row strip p and column
//             strip p of D from its peers and computes d_img's rows of tile
//             p and d_txt's rows of tile p over the q-th share of E's
//             columns, D read from shared memory.
// B > 256: a persistent cooperative launch (grid.cuh) over 64 x 64 tiles,
// two blocks an SM.
//   forward:  1: each tile's statistics and the diagonal into scratch; grid
//             barrier; 2: the 2B rows and columns split evenly over the
//             blocks, each merged across the tiles in order (its loads all
//             issued first), six partial sums a block; the last block to
//             finish adds them, a warp a sum (lanes over the blocks in
//             order, then a shuffle tree).
//   backward: 1: each tile's D into scratch [B, B] and its sum D * l; grid
//             barrier; 2: d_img and d_txt as 64 x 64 output tiles of D . txt
//             and D^T . img (K = B, D through L2); block 0's first warp adds
//             the tiles' D * l as above.
// Every merge and sum runs in a fixed order with no float atomics: a
// repeated call gives the same bits. The barrier counts live in a buffer
// the caller keeps per stream and are left as found (no fill launch); the
// launches' set-up is queried once per device (grid.cuh::LaunchCache).
//
// What bounds it on an H100: at B = 1024, E = 512 the products (forward
// 1.07 GFLOP, backward 3.2 GFLOP of f32 work, three times that as TF32);
// at B = 128 the host's side of a call (its Python wrapper and the launch
// take longer than the 15 to 25 us the kernels run).

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "grid.cuh"
#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT_THREADS = 256;
constexpr int BK = 32;        // the ring's K chunk
constexpr int SMALL_B = 256;  // up to here: one cluster
constexpr int GRID_T = 64;    // the tile above it
constexpr int MAX_GRID_TILES = 16;  // ceil(1024 / 64) tiles a line
constexpr int MAX_PART_BLOCKS = 256;
// ring stages (chunks in flight + 1): the cluster's forward, its backward's
// two products, the grid's
constexpr int FWD_STAGES = 8, BWD_STAGES = 6, BWD2_STAGES = 4;
constexpr int GRID_STAGES = 4;

// ------------------------------------------------------------ the engine

// An operand chunk in shared memory: element (row x, k) at
// p[x * pitch + k] (k-contiguous, "xk") or p[k * pitch + x] ("kx"). The
// pitches put a fragment's 32 lanes on 32 banks: pitch % 32 == 4 (xk) or
// 8 (kx).
struct Chunk {
  const float* p;
  int pitch;
};

__host__ __device__ constexpr int xk_pitch() { return BK + 4; }
__host__ __device__ constexpr int kx_pitch(int X) { return X + 8; }
__host__ __device__ constexpr int stage_floats(int X) {
  return X * xk_pitch() > BK * kx_pitch(X) ? X * xk_pitch()
                                           : BK * kx_pitch(X);
}

// Rows [x0, x0 + X) of a global row-major [rows, K] operand (K
// contiguous): chunk [k0, k0 + BK) issued into `dst` as xk (cp.async;
// zeros past rows or K) and viewed there.
template <int X>
struct GlobalXK {
  const float* src;
  int ld, x0, rows, K;
  __device__ void issue(float* dst, int k0) const {
    for (int e = threadIdx.x; e < X * (BK / 4); e += NT_THREADS) {
      const int x = e / (BK / 4);
      const int k = k0 + 4 * (e % (BK / 4));
      const bool ok = x0 + x < rows && k < K;
      cp_async16(dst + x * xk_pitch() + k - k0,
                 src + (ok ? static_cast<size_t>(x0 + x) * ld + k : 0), ok);
    }
  }
  __device__ Chunk view(const float* dst, int) const {
    return {dst, xk_pitch()};
  }
};

// Columns [x0, x0 + X) of a global row-major [K, cols] operand (x
// contiguous): chunk [k0, k0 + BK) issued into `dst` as kx (zeros past
// cols or K) and viewed there.
template <int X>
struct GlobalKX {
  const float* src;
  int ld, x0, cols, K;
  __device__ void issue(float* dst, int k0) const {
    for (int e = threadIdx.x; e < BK * (X / 4); e += NT_THREADS) {
      const int k = e / (X / 4);
      const int x = 4 * (e % (X / 4));
      const bool ok = x0 + x < cols && k0 + k < K;
      cp_async16(dst + k * kx_pitch(X) + x,
                 src + (ok ? static_cast<size_t>(k0 + k) * ld + x0 + x : 0),
                 ok);
    }
  }
  __device__ Chunk view(const float* dst, int) const {
    return {dst, kx_pitch(X)};
  }
};

// An operand already whole in shared memory (a gathered strip of D): no
// copies; a chunk is read where it lies.
struct Resident {
  const float* p;
  int pitch;
  bool kx;
  __device__ void issue(float*, int) const {}
  __device__ Chunk view(const float*, int k0) const {
    return {kx ? p + static_cast<size_t>(k0) * pitch : p + k0, pitch};
  }
};

// The accumulators of a TM x TN tile: warp (wm, wn) = (w / 4, w % 4) owns
// rows wm TM / 2 .. and columns wn TN / 4 ..; element (mi, ni, i) is at row
// wm TM/2 + 16 mi + g + 8 (i / 2), column wn TN/4 + 8 ni + 2 q + i % 2.
template <int TM, int TN>
struct Acc {
  static constexpr int MI = TM / 32, NI = TN / 32;
  float main[MI][NI][4], corr[MI][NI][4];
  __device__ float at(int mi, int ni, int i) const {
    return main[mi][ni][i] + corr[mi][ni][i];
  }
  __device__ static int row(int mi, int i) {
    return (threadIdx.x / 128) * (TM / 2) + 16 * mi + (threadIdx.x % 32) / 4 +
           8 * (i / 2);
  }
  __device__ static int col(int ni, int i) {
    return ((threadIdx.x / 32) % 4) * (TN / 4) + 8 * ni +
           2 * (threadIdx.x % 4) + i % 2;
  }
};

// acc = A . B^T over K: A (TM x K) and B (TN x K) staged chunk by chunk by
// `la` and `lb` (A_KX / B_KX: the chunks' layouts) through a ring of
// STAGES stages, STAGES - 1 chunks in flight: A's stages at ring_a
// (STAGES stage_floats(TM) floats; not touched for a resident A), B's at
// ring_b (STAGES stage_floats(TN)).
template <int TM, int TN, bool A_KX, bool B_KX, int STAGES, class LA,
          class LB>
__device__ void tile_product(Acc<TM, TN>& acc, const LA& la, const LB& lb,
                             int K, float* ring_a, float* ring_b) {
  constexpr int MI = Acc<TM, TN>::MI, NI = Acc<TM, TN>::NI;
  constexpr int SA = stage_floats(TM), SB = stage_floats(TN);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = (threadIdx.x / 128) * (TM / 2);
  const int n0 = ((threadIdx.x / 32) % 4) * (TN / 4);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.main[mi][ni][i] = acc.corr[mi][ni][i] = 0;
  const int nk = (K + BK - 1) / BK;
  __syncthreads();  // the ring is free
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nk) {
      la.issue(ring_a + c * SA, c * BK);
      lb.issue(ring_b + c * SB, c * BK);
    }
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int ahead = kc + STAGES - 1;
    if (ahead < nk) {
      la.issue(ring_a + (ahead % STAGES) * SA, ahead * BK);
      lb.issue(ring_b + (ahead % STAGES) * SB, ahead * BK);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const Chunk a = la.view(ring_a + (kc % STAGES) * SA, kc * BK);
    const Chunk b = lb.view(ring_b + (kc % STAGES) * SB, kc * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int k = 8 * ks + q;
      uint32_t ahi[MI][4], alo[MI][4], bhi[NI][2], blo[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int m = m0 + 16 * mi + g;
        float v[4];
        if (A_KX) {
          v[0] = a.p[k * a.pitch + m];
          v[1] = a.p[k * a.pitch + m + 8];
          v[2] = a.p[(k + 4) * a.pitch + m];
          v[3] = a.p[(k + 4) * a.pitch + m + 8];
        } else {
          v[0] = a.p[m * a.pitch + k];
          v[1] = a.p[(m + 8) * a.pitch + k];
          v[2] = a.p[m * a.pitch + k + 4];
          v[3] = a.p[(m + 8) * a.pitch + k + 4];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[mi][i], alo[mi][i]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + 8 * ni + g;
        const float v0 = B_KX ? b.p[k * b.pitch + n] : b.p[n * b.pitch + k];
        const float v1 =
            B_KX ? b.p[(k + 4) * b.pitch + n] : b.p[n * b.pitch + k + 4];
        split_tf32(v0, bhi[ni][0], blo[ni][0]);
        split_tf32(v1, bhi[ni][1], blo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_3xtf32(acc.main[mi][ni], acc.corr[mi][ni], ahi[mi], alo[mi],
                     bhi[ni], blo[ni]);
    }
    __syncthreads();  // the stage is read before it is refilled
  }
}

// ----------------------------------------------------------- statistics

// (max, sum e^(l - max), sum e^(l - max) (l - max)) of a run of logits;
// s == 0: an empty run
struct Stats {
  float m, s, w;
};

__device__ __forceinline__ Stats merge(const Stats a, const Stats b) {
  if (b.s == 0.0f) return a;
  if (a.s == 0.0f) return b;
  const float m = fmaxf(a.m, b.m);
  const float ea = expf(a.m - m);
  const float eb = expf(b.m - m);
  return {m, a.s * ea + b.s * eb,
          ea * (a.w + (a.m - m) * a.s) + eb * (b.w + (b.m - m) * b.s)};
}

__device__ __forceinline__ Stats shfl_xor(const Stats v, int mask) {
  return {__shfl_xor_sync(0xffffffffu, v.m, mask),
          __shfl_xor_sync(0xffffffffu, v.s, mask),
          __shfl_xor_sync(0xffffffffu, v.w, mask)};
}

// The statistics of the first `n` of the `T` values of each row (cols
// false) or column (true) of Ls [T][T + 1], NT_THREADS / T threads a line
// (each a contiguous run, then merged across the threads by shuffles in a
// fixed tree); the result is valid in every thread of the line. Returns
// the line (tid / (NT_THREADS / T)).
template <int T>
__device__ Stats line_stats(const float* Ls, bool cols, int n, int* line) {
  constexpr int TPL = NT_THREADS / T;
  constexpr int RUN = T / TPL;
  const int x = threadIdx.x / TPL;
  const int sub = threadIdx.x % TPL;
  const int c0 = sub * RUN;
  const int c1 = min(c0 + RUN, n);
  Stats st = {-INFINITY, 0.0f, 0.0f};
  if (c0 < c1) {
    float mx = -INFINITY;
    for (int c = c0; c < c1; ++c)
      mx = fmaxf(mx, cols ? Ls[c * (T + 1) + x] : Ls[x * (T + 1) + c]);
    float s = 0.0f, w = 0.0f;
    for (int c = c0; c < c1; ++c) {
      const float d = (cols ? Ls[c * (T + 1) + x] : Ls[x * (T + 1) + c]) - mx;
      const float e = expf(d);
      s += e;
      w = fmaf(e, d, w);
    }
    st = {mx, s, w};
  }
#pragma unroll
  for (int mask = 1; mask < TPL; mask <<= 1) st = merge(st, shfl_xor(st, mask));
  *line = x;
  return st;
}

// The block's sums of six values per thread, in a fixed tree; valid in
// thread 0. red: 6 NT_THREADS floats.
__device__ void block_sum6(float (&v)[6], float* red) {
#pragma unroll
  for (int q = 0; q < 6; ++q) red[q * NT_THREADS + threadIdx.x] = v[q];
  __syncthreads();
  for (int n = NT_THREADS / 2; n > 0; n >>= 1) {
    if (static_cast<int>(threadIdx.x) < n)
#pragma unroll
      for (int q = 0; q < 6; ++q)
        red[q * NT_THREADS + threadIdx.x] +=
            red[q * NT_THREADS + threadIdx.x + n];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) v[q] = red[q * NT_THREADS];
  __syncthreads();
}

// The sum of v[0], v[stride], ... v[(n - 1) stride] (through L2) by one
// warp: lane l adds l, l + 32, ... in order, then a shuffle tree; the same
// bits in every lane
__device__ __forceinline__ float warp_sum(const float* v, int stride, int n) {
  float t = 0.0f;
  for (int i = threadIdx.x % 32; i < n; i += 32) t += __ldcg(v + i * stride);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
  return t;
}

// One row's or column's share of the sums: cross-entropy, accuracy,
// entropy (slots side, 2 + side, 4 + side); returns its LSE
__device__ __forceinline__ float add_line(const Stats st, float l_ii,
                                          int side, float (&v)[6]) {
  const float log_s = logf(st.s);
  const float lse = st.m + log_s;
  v[side] += lse - l_ii;
  v[2 + side] += l_ii >= st.m ? 1.0f : 0.0f;
  v[4 + side] += log_s - st.w / st.s;
  return lse;
}

__device__ __forceinline__ void write_sums(const float (&tot)[6], int B,
                                           float* loss, float* metrics) {
  loss[0] = (tot[0] + tot[1]) / (2.0f * B);
  for (int q = 0; q < 4; ++q) metrics[q] = tot[2 + q] / B;
}

struct FwdArgs {
  const float *img, *txt, *nlt;
  float* part;  // B > 256: 6 [tiles][B] planes, diag [B], block sums
  float *loss, *lse_i, *lse_t, *metrics;
  unsigned* bar;  // B > 256: arrivals, generation, tickets
  int B, E;
};

struct BwdArgs {
  const float *img, *txt, *nlt, *lse_i, *lse_t, *g;
  float *D, *part;  // B > 256: D [B, B]; part [tiles]
  float *dimg, *dtxt, *dnlt;
  unsigned* bar;
  int B, E;
};

// The logits tile (bi, bj) as T x T values l = s img . txt^T into Ls
// [T][T + 1]
template <int T, int STAGES>
__device__ void logits_tile(const float* img, const float* txt, int B, int E,
                            int bi, int bj, float scale, float* ring_a,
                            float* ring_b, float* Ls) {
  Acc<T, T> acc;
  tile_product<T, T, false, false, STAGES>(
      acc, GlobalXK<T>{img, E, bi * T, B, E}, GlobalXK<T>{txt, E, bj * T, B, E},
      E, ring_a, ring_b);
#pragma unroll
  for (int mi = 0; mi < Acc<T, T>::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < Acc<T, T>::NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ls[Acc<T, T>::row(mi, i) * (T + 1) + Acc<T, T>::col(ni, i)] =
            scale * acc.at(mi, ni, i);
  __syncthreads();
}

// ------------------------------------------------- B <= 256: one cluster

template <int T>
struct FwdSmem {
  float ring_a[FWD_STAGES * stage_floats(T)];
  float ring_b[FWD_STAGES * stage_floats(T)];
  float l[T * (T + 1)];
  float st[6][T];  // rows (m, s, w), columns (m, s, w)
  float diag[T];
  float red[6 * NT_THREADS];
  float sums[16][6];  // block 0: each block's six sums
};

template <int T>
__global__ void __launch_bounds__(NT_THREADS, 1)
    infonce_fwd_cluster(const FwdArgs p) {
  extern __shared__ __align__(16) unsigned char raw[];
  FwdSmem<T>& s = *reinterpret_cast<FwdSmem<T>*>(raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int B = p.B;
  const int nt = (B + T - 1) / T;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bi = rank / nt, bj = rank % nt;
  const float scale = expf(__ldg(p.nlt));

  logits_tile<T, FWD_STAGES>(p.img, p.txt, B, p.E, bi, bj, scale, s.ring_a,
                             s.ring_b, s.l);
  const int rows = min(T, B - bi * T), cols = min(T, B - bj * T);
  for (int side = 0; side < 2; ++side) {
    int x;
    const Stats st = line_stats<T>(s.l, side == 1, side ? rows : cols, &x);
    if (threadIdx.x % (NT_THREADS / T) == 0) {
      s.st[3 * side][x] = st.m;
      s.st[3 * side + 1][x] = st.s;
      s.st[3 * side + 2][x] = st.w;
    }
  }
  if (bi == bj && static_cast<int>(threadIdx.x) < T)
    s.diag[threadIdx.x] = s.l[threadIdx.x * (T + 2)];
  cluster.sync();

  // block (bi, bj): rows [lo, hi) of row tile bi and the same columns of
  // column tile bi, merged over the nt tiles in order
  const int lo = bj * T / nt, hi = (bj + 1) * T / nt;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int items = hi - lo;
  if (static_cast<int>(threadIdx.x) < 2 * items) {
    const int side = static_cast<int>(threadIdx.x) / items;
    const int r = lo + static_cast<int>(threadIdx.x) % items;
    const int idx = bi * T + r;
    if (idx < B) {
      Stats st = {-INFINITY, 0.0f, 0.0f};
      for (int x = 0; x < nt; ++x) {
        // row side: tile (bi, x); column side: tile (x, bi)
        FwdSmem<T>* peer = cluster.map_shared_rank(
            &s, side ? x * nt + bi : bi * nt + x);
        st = merge(st, {peer->st[3 * side][r], peer->st[3 * side + 1][r],
                        peer->st[3 * side + 2][r]});
      }
      const float l_ii =
          cluster.map_shared_rank(&s, bi * nt + bi)->diag[r];
      const float lse = add_line(st, l_ii, side, v);
      (side ? p.lse_t : p.lse_i)[idx] = lse;
    }
  }
  block_sum6(v, s.red);
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(&s.sums[0][0], 0);
    for (int q = 0; q < 6; ++q) dst[rank * 6 + q] = v[q];
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float tot[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int b = 0; b < nt * nt; ++b)
      for (int q = 0; q < 6; ++q) tot[q] += s.sums[b][q];
    write_sums(tot, B, p.loss, p.metrics);
  }
}

template <int T>
struct BwdSmem {
  union {
    struct {  // the logits tile's ring
      float ring_a[BWD_STAGES * stage_floats(T)];
      float ring_b[BWD_STAGES * stage_floats(T)];
    } one;
    struct {  // the strips of D, gathered after it
      float drow[T * (SMALL_B + 4)];      // row strip: [T][nt T + 4]
      float dcol[SMALL_B * kx_pitch(T)];  // column strip: [nt T][T + 8]
    } two;
  } u;
  float ring2[BWD2_STAGES * stage_floats(64)];  // txt's or img's chunks
  float l[T * (T + 1)];
  float dt[T * (T + 4)];  // this block's D tile
  float red[6 * NT_THREADS];
  float sums[16];
};

template <int T>
__global__ void __launch_bounds__(NT_THREADS, 1)
    infonce_bwd_cluster(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char raw[];
  BwdSmem<T>& s = *reinterpret_cast<BwdSmem<T>*>(raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int B = p.B, E = p.E;
  const int nt = (B + T - 1) / T;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bi = rank / nt, bj = rank % nt;
  const float scale = expf(__ldg(p.nlt));
  const float coef = __ldg(p.g) / (2.0f * B);

  logits_tile<T, BWD_STAGES>(p.img, p.txt, B, E, bi, bj, scale,
                             s.u.one.ring_a, s.u.one.ring_b, s.l);
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e = threadIdx.x; e < T * T; e += NT_THREADS) {
    const int r = e / T, c = e % T;
    const int gr = bi * T + r, gc = bj * T + c;
    float d = 0.0f;
    if (gr < B && gc < B) {
      const float l = s.l[r * (T + 1) + c];
      const float eye = gr == gc ? 2.0f : 0.0f;
      d = coef * ((expf(l - __ldg(p.lse_i + gr)) +
                   expf(l - __ldg(p.lse_t + gc))) - eye);
      v[0] = fmaf(d, l, v[0]);
    }
    s.dt[r * (T + 4) + c] = d;
  }
  block_sum6(v, s.red);
  if (threadIdx.x == 0) cluster.map_shared_rank(&s.sums[0], 0)[rank] = v[0];
  cluster.sync();

  // row strip bi: tiles (bi, x); column strip bi: tiles (x, bi)
  const int KB = nt * T;
  const int rp = KB + 4;
  for (int e = threadIdx.x; e < nt * T * (T / 4); e += NT_THREADS) {
    const int x = e / (T * (T / 4));
    const int r = (e / (T / 4)) % T;
    const int c = 4 * (e % (T / 4));
    const float4 a = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(&s.dt[0], bi * nt + x) + r * (T + 4) + c);
    *reinterpret_cast<float4*>(&s.u.two.drow[r * rp + x * T + c]) = a;
    const float4 b = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(&s.dt[0], x * nt + bi) + r * (T + 4) + c);
    *reinterpret_cast<float4*>(&s.u.two.dcol[(x * T + r) * kx_pitch(T) + c]) =
        b;
  }
  if (rank == 0 && threadIdx.x == 0) {
    float tot = 0.0f;
    for (int b = 0; b < nt * nt; ++b) tot += s.sums[b];
    p.dnlt[0] = tot;
  }
  cluster.sync();  // no block reads another's shared memory after this

  // d_img rows of tile bi, d_txt rows of tile bi: E's columns in shares of
  // whole 64-column tiles, share bj
  const int ne = (E + 63) / 64;
  const int per = (ne + nt - 1) / nt;
  for (int side = 0; side < 2; ++side) {
    float* out = side ? p.dtxt : p.dimg;
    const float* rhs = side ? p.img : p.txt;
    for (int et = bj * per; et < min(ne, (bj + 1) * per); ++et) {
      Acc<T, 64> acc;
      if (side == 0)
        tile_product<T, 64, false, true, BWD2_STAGES>(
            acc, Resident{s.u.two.drow, rp, false},
            GlobalKX<64>{rhs, E, et * 64, E, B}, KB, s.ring2, s.ring2);
      else
        tile_product<T, 64, true, true, BWD2_STAGES>(
            acc, Resident{s.u.two.dcol, kx_pitch(T), true},
            GlobalKX<64>{rhs, E, et * 64, E, B}, KB, s.ring2, s.ring2);
#pragma unroll
      for (int mi = 0; mi < Acc<T, 64>::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < Acc<T, 64>::NI; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = bi * T + Acc<T, 64>::row(mi, i);
            const int c = et * 64 + Acc<T, 64>::col(ni, i);
            if (r < B && c < E)
              out[static_cast<size_t>(r) * E + c] = scale * acc.at(mi, ni, i);
          }
    }
  }
}

// ---------------------------------------- B > 256: one cooperative launch

struct GridSmem {
  float ring_a[GRID_STAGES * stage_floats(GRID_T)];
  float ring_b[GRID_STAGES * stage_floats(GRID_T)];
  float l[GRID_T * (GRID_T + 1)];
  float red[6 * NT_THREADS];
  int last;
};

// two blocks an SM: four warps a sub-partition hide the mma's latency
__global__ void __launch_bounds__(NT_THREADS, 2)
    infonce_fwd_grid(const FwdArgs p) {
  constexpr int T = GRID_T;
  extern __shared__ __align__(16) unsigned char raw[];
  GridSmem& s = *reinterpret_cast<GridSmem*>(raw);
  const int B = p.B;
  const int nt = (B + T - 1) / T;
  const size_t plane = static_cast<size_t>(nt) * B;
  float* diag = p.part + 6 * plane;
  float* sums = diag + B;  // [gridDim.x][6]
  const float scale = expf(__ldg(p.nlt));

  for (int tile = blockIdx.x; tile < nt * nt; tile += gridDim.x) {
    const int bi = tile / nt, bj = tile % nt;
    logits_tile<T, GRID_STAGES>(p.img, p.txt, B, p.E, bi, bj, scale,
                                s.ring_a, s.ring_b, s.l);
    const int rows = min(T, B - bi * T), cols = min(T, B - bj * T);
    for (int side = 0; side < 2; ++side) {
      int x;
      const Stats st = line_stats<T>(s.l, side == 1, side ? rows : cols, &x);
      if (threadIdx.x % (NT_THREADS / T) == 0 && x < (side ? cols : rows)) {
        // row side: row bi T + x, tile bj; column side: column bj T + x,
        // tile bi
        const size_t at = side ? 3 * plane + static_cast<size_t>(bi) * B +
                                     bj * T + x
                               : static_cast<size_t>(bj) * B + bi * T + x;
        p.part[at] = st.m;
        p.part[at + plane] = st.s;
        p.part[at + 2 * plane] = st.w;
      }
    }
    if (bi == bj && static_cast<int>(threadIdx.x) < rows)
      diag[bi * T + threadIdx.x] = s.l[threadIdx.x * (T + 2)];
  }
  grid_sync(p.bar);

  // the 2B lines (rows, then columns), an even share a block
  const int per = (2 * B + gridDim.x - 1) / gridDim.x;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int it = blockIdx.x * per + threadIdx.x;
       it < min(2 * B, (static_cast<int>(blockIdx.x) + 1) * per);
       it += NT_THREADS) {
    const int side = it / B, i = it % B;
    const float* mp = p.part + 3 * side * plane + i;
    Stats part[MAX_GRID_TILES];  // all loads first, then the merges
#pragma unroll
    for (int tl = 0; tl < MAX_GRID_TILES; ++tl)
      if (tl < nt) {
        const size_t at = static_cast<size_t>(tl) * B;
        part[tl] = {__ldcg(mp + at), __ldcg(mp + plane + at),
                    __ldcg(mp + 2 * plane + at)};
      }
    Stats st = {-INFINITY, 0.0f, 0.0f};
#pragma unroll
    for (int tl = 0; tl < MAX_GRID_TILES; ++tl)
      if (tl < nt) st = merge(st, part[tl]);
    (side ? p.lse_t : p.lse_i)[i] = add_line(st, __ldcg(diag + i), side, v);
  }
  block_sum6(v, s.red);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 6; ++q) sums[blockIdx.x * 6 + q] = v[q];
    __threadfence();
    s.last = atomicAdd(p.bar + 2, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s.last) {  // the last block: warp q adds the blocks' sums q
    __threadfence();
    const int q = threadIdx.x / 32;
    if (q < 6) {
      const float t = warp_sum(sums + q, 6, gridDim.x);
      if (threadIdx.x % 32 == 0) s.red[q] = t;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const float tot[6] = {s.red[0], s.red[1], s.red[2],
                            s.red[3], s.red[4], s.red[5]};
      write_sums(tot, B, p.loss, p.metrics);
      atomicExch(p.bar + 2, 0u);
    }
  }
}

__global__ void __launch_bounds__(NT_THREADS, 2)
    infonce_bwd_grid(const BwdArgs p) {
  constexpr int T = GRID_T;
  extern __shared__ __align__(16) unsigned char raw[];
  GridSmem& s = *reinterpret_cast<GridSmem*>(raw);
  const int B = p.B, E = p.E;
  const int nt = (B + T - 1) / T;
  const int ne = (E + T - 1) / T;
  const float scale = expf(__ldg(p.nlt));
  const float coef = __ldg(p.g) / (2.0f * B);

  for (int tile = blockIdx.x; tile < nt * nt; tile += gridDim.x) {
    const int bi = tile / nt, bj = tile % nt;
    logits_tile<T, GRID_STAGES>(p.img, p.txt, B, E, bi, bj, scale, s.ring_a,
                                s.ring_b, s.l);
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = threadIdx.x; e < T * T; e += NT_THREADS) {
      const int r = bi * T + e / T, c = bj * T + e % T;
      if (r >= B || c >= B) continue;
      const float l = s.l[(e / T) * (T + 1) + e % T];
      const float eye = r == c ? 2.0f : 0.0f;
      const float d = coef * ((expf(l - __ldg(p.lse_i + r)) +
                               expf(l - __ldg(p.lse_t + c))) - eye);
      p.D[static_cast<size_t>(r) * B + c] = d;
      v[0] = fmaf(d, l, v[0]);
    }
    block_sum6(v, s.red);
    if (threadIdx.x == 0) p.part[tile] = v[0];
  }
  grid_sync(p.bar);

  if (blockIdx.x == 0 && threadIdx.x < 32) {  // d(neg_log_temp)
    const float tot = warp_sum(p.part, 1, nt * nt);
    if (threadIdx.x == 0) p.dnlt[0] = tot;
  }
  // d_img tiles, then d_txt tiles: [B, E] each, K = B
  for (int tile = blockIdx.x; tile < 2 * nt * ne; tile += gridDim.x) {
    const bool t_side = tile >= nt * ne;
    const int q = tile % (nt * ne);
    const int m0 = (q / ne) * T;
    const int n0 = (q % ne) * T;
    Acc<T, T> acc;
    // d_img[m, n] = sum_k D[m, k] txt[k, n]; d_txt[m, n] = sum_k D[k, m]
    // img[k, n]
    if (t_side)
      tile_product<T, T, true, true, GRID_STAGES>(
          acc, GlobalKX<T>{p.D, B, m0, B, B}, GlobalKX<T>{p.img, E, n0, E, B},
          B, s.ring_a, s.ring_b);
    else
      tile_product<T, T, false, true, GRID_STAGES>(
          acc, GlobalXK<T>{p.D, B, m0, B, B}, GlobalKX<T>{p.txt, E, n0, E, B},
          B, s.ring_a, s.ring_b);
    float* out = t_side ? p.dtxt : p.dimg;
#pragma unroll
    for (int mi = 0; mi < Acc<T, T>::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < Acc<T, T>::NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + Acc<T, T>::row(mi, i);
          const int c = n0 + Acc<T, T>::col(ni, i);
          if (r < B && c < E)
            out[static_cast<size_t>(r) * E + c] = scale * acc.at(mi, ni, i);
        }
  }
}

// ------------------------------------------------------------- launches

template <class Kernel, class Args>
cudaError_t launch_cluster(Kernel kernel, const Args& args, int blocks,
                           int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// The small path's kernel at B: its tile side, blocks and shared memory
template <template <int> class Smem, class Args>
cudaError_t launch_small(void (*k32)(Args), void (*k64)(Args),
                         LaunchCache& c32, LaunchCache& c64, const Args& p,
                         int B, cudaStream_t stream) {
  const bool wide = B > 128;
  const int T = wide ? 64 : 32;
  const int nt = (B + T - 1) / T;
  const int smem = static_cast<int>(wide ? sizeof(Smem<64>)
                                         : sizeof(Smem<32>));
  int on_card = 0;
  cudaError_t err = (wide ? c64 : c32)
                        .blocks(wide ? k64 : k32, NT_THREADS, smem, smem,
                                true, &on_card);
  if (err != cudaSuccess) return err;
  return launch_cluster(wide ? k64 : k32, p, nt * nt, smem, stream);
}

}  // namespace

// Shapes are checked by the Python wrapper (multimodal_baby_tpu_torch/ops/
// infonce.py): f32, contiguous, 16-byte aligned; img, txt [B, E] with
// B % 4 == 0, E % 4 == 0, 4 <= B <= 1024; nlt, loss scalars; lse_i, lse_t
// [B]; metrics [4]. B > 256 only: part scratch of 6 ceil(B/64) B + B +
// 6 x 256 floats, bar three words (arrivals zero, generation any, tickets
// zero; left so) not used by another call at the same time.
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (B <= SMALL_B) {
    static LaunchCache c32, c64;
    return static_cast<int>(launch_small<FwdSmem>(
        infonce_fwd_cluster<32>, infonce_fwd_cluster<64>, c32, c64, p, B,
        st));
  }
  static LaunchCache cache;
  const int smem = static_cast<int>(sizeof(GridSmem));
  int on_card = 0;
  cudaError_t err = cache.blocks(infonce_fwd_grid, NT_THREADS, smem, smem,
                                 false, &on_card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (B + GRID_T - 1) / GRID_T;
  int grid = on_card < nt * nt ? on_card : nt * nt;
  if (grid > MAX_PART_BLOCKS) grid = MAX_PART_BLOCKS;
  return static_cast<int>(
      launch_cooperative(infonce_fwd_grid, p, grid, NT_THREADS, smem, st));
}

// g the loss's cotangent (a scalar); dimg, dtxt [B, E]; dnlt a scalar.
// B > 256 only: D [B, B] and part [ceil(B/64)^2] scratch, bar as the
// forward's.
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (B <= SMALL_B) {
    static LaunchCache c32, c64;
    return static_cast<int>(launch_small<BwdSmem>(
        infonce_bwd_cluster<32>, infonce_bwd_cluster<64>, c32, c64, p, B,
        st));
  }
  static LaunchCache cache;
  const int smem = static_cast<int>(sizeof(GridSmem));
  int on_card = 0;
  cudaError_t err = cache.blocks(infonce_bwd_grid, NT_THREADS, smem, smem,
                                 false, &on_card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (B + GRID_T - 1) / GRID_T;
  const int ne = (E + GRID_T - 1) / GRID_T;
  const int tiles = nt * nt > 2 * nt * ne ? nt * nt : 2 * nt * ne;
  const int grid = on_card < tiles ? on_card : tiles;
  return static_cast<int>(
      launch_cooperative(infonce_bwd_grid, p, grid, NT_THREADS, smem, st));
}
