// The masked LSTM recurrence (K9) on Hopper (sm_90a), f32 throughout (FMA,
// no TF32): for t = 0 .. L-1, with gates in the order i, f, g, o,
//
//   pre   = x_proj[t] + h . W_hh                      [B, 4H]
//   c_new = sig(f) c + sig(i) tanh(g);  h_new = sig(o) tanh(c_new)
//   h     = m h_new + (1 - m) h;  c = m c_new + (1 - m) c;  out[t] = m h_new
//
// with m = mask[t, b] in {0, 1}. Replaces the TPU kernel
// multimodal_baby_tpu/ops/lstm.py::lstm_fused (`_lstm_kernel`), which keeps
// h, c and the whole W_hh in VMEM across a sequential grid over t.
//
// W_hh is [H, 4H] = 4 MB at H = 512 and one SM has 227 KB, so the step's
// product is spread over the card: one persistent cooperative launch
// (grid.cuh) per sequence, with a grid barrier between time steps. Each
// block owns 16 hidden units: their four gate columns of W_hh stay in
// shared memory for the whole sequence ([k][unit][gate], 64 H bytes), and
// for each tile of 32 batch rows it copies h_{t-1} [32, H] from L2
// (cp.async.cg: other blocks wrote it before the barrier), computes the
// 32 x 64 gate sums, and applies the gates. Two halves of 128 threads split
// the K = H sum and add their halves through shared memory; a thread owns
// 4 batch rows (b, b + 8, b + 16, b + 24) x the 4 gates of one unit, so each
// 16-byte load of h and of W_hh feeds 16 FMAs. h alternates between two
// [B, H] buffers; c lives in c_last, each entry read and written by the
// thread that owns it.
//
// What bounds it on an H100: the FMA rate and the step latency. At CVCL's
// B = 128, H = 512 a step is 268 MFLOP (4 us at 67 TFLOP/s) spread over 128
// blocks, one per SM, plus a barrier and an L2 read of h (8 MB over all
// blocks) per step; the 25 or 64 steps are dependent.

#include "common.cuh"
#include "grid.cuh"

namespace {

constexpr int LSTM_THREADS = 256;  // two halves of the K sum
constexpr int LSTM_HALF = LSTM_THREADS / 2;
constexpr int UNITS = 16;          // hidden units per block
constexpr int ROWS = 32;           // batch rows per tile

struct LstmArgs {
  const float *xp, *mask, *whh, *h0, *c0;
  float *out, *h_last, *c_last, *hbuf;  // hbuf: two [B, H] buffers
  unsigned* bar;                        // two zeroed words
  int L, B, H;
};

// W_hh's slice, the h tile and the halves' exchange, in floats
size_t lstm_smem(int H) {
  return (static_cast<size_t>(H) * UNITS * 4 + ROWS * (H + 4) +
          LSTM_HALF * 16) * 4;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float comp(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the named barrier of one half's 128 threads
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(half + 1), "r"(LSTM_HALF));
}

__global__ void __launch_bounds__(LSTM_THREADS, 1)
    lstm_kernel(const LstmArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H;
  const int B = p.B;
  const int S = H + 4;  // the h tile's pitch: 4 row groups on 4 bank groups
  float* Ws = smem;                                  // [H][UNITS][4]
  float* Hs = Ws + static_cast<size_t>(H) * UNITS * 4;  // [ROWS][S]
  float* red = Hs + ROWS * S;                        // [16][LSTM_HALF]

  const int tiles_u = H / UNITS;
  const int groups = gridDim.x / tiles_u;  // blocks per unit tile
  const int tiles_r = (B + ROWS - 1) / ROWS;
  const bool active = static_cast<int>(blockIdx.x) < tiles_u * groups;
  const int ut = blockIdx.x % tiles_u;
  const int j0 = ut * UNITS;

  const int tid = threadIdx.x;
  const int half = tid / LSTM_HALF;
  const int lt = tid % LSTM_HALF;
  const int warp = lt >> 5;
  const int lane = lt & 31;
  const int rg = (warp & 1) * 4 + (lane >> 3);  // rows rg + 8 i
  const int ju = (warp >> 1) * 8 + (lane & 7);  // unit j0 + ju
  const int j = j0 + ju;
  const int kh = H / 2;
  const int k_lo = half * kh;

  if (active) {
    // this block's gate columns, once: Ws[k][u][g] = W_hh[k, g H + j0 + u]
    for (int e = tid; e < H * 4 * (UNITS / 4); e += LSTM_THREADS) {
      const int q = e % (UNITS / 4);
      const int g = (e / (UNITS / 4)) % 4;
      const int k = e / (UNITS / 4) / 4;
      const float4 w = __ldg(reinterpret_cast<const float4*>(
          p.whh + static_cast<size_t>(k) * 4 * H + g * H + j0 + q * 4));
      float* dst = Ws + (static_cast<size_t>(k) * UNITS + q * 4) * 4 + g;
      dst[0] = w.x;
      dst[4] = w.y;
      dst[8] = w.z;
      dst[12] = w.w;
    }
  }
  __syncthreads();

  for (int t = 0; t < p.L; ++t) {
    const float* h_prev =
        t == 0 ? p.h0 : p.hbuf + static_cast<size_t>((t - 1) & 1) * B * H;
    const float* c_prev = t == 0 ? p.c0 : p.c_last;
    float* h_next = t == p.L - 1 ? p.h_last
                                 : p.hbuf + static_cast<size_t>(t & 1) * B * H;
    for (int rt = active ? static_cast<int>(blockIdx.x) / tiles_u : tiles_r;
         rt < tiles_r; rt += groups) {
      const int r0 = rt * ROWS;
      // this half's columns of h_{t-1} for the tile's rows, in two chunks
      const int per_row = kh / 4;  // 16-byte pieces of a half row
      for (int c = 0; c < 2; ++c) {
        for (int e = lt; e < ROWS * per_row / 2; e += LSTM_HALF) {
          const int row = e / (per_row / 2);
          const int k = k_lo + (c * (per_row / 2) + e % (per_row / 2)) * 4;
          const int b = r0 + row;
          cp_async16(Hs + row * S + k,
                     h_prev + static_cast<size_t>(b < B ? b : 0) * H + k,
                     b < B);
        }
        cp_async_commit();
      }
      // the step's inputs for the gates, loaded while h arrives
      float xp[4][4];
      float m[4];
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = r0 + rg + 8 * i;
          const size_t row = (static_cast<size_t>(t) * B + (b < B ? b : 0));
#pragma unroll
          for (int g = 0; g < 4; ++g)
            xp[i][g] = __ldg(p.xp + row * 4 * H + g * H + j);
          m[i] = __ldg(p.mask + row);
        }
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
      for (int c = 0; c < 2; ++c) {
        if (c == 0)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        half_sync(half);
        const int k_end = k_lo + (c + 1) * (kh / 2);
#pragma unroll 2
        for (int k = k_lo + c * (kh / 2); k < k_end; k += 4) {
          float4 hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            hv[i] = *reinterpret_cast<const float4*>(Hs + (rg + 8 * i) * S +
                                                     k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = *reinterpret_cast<const float4*>(
                Ws + (static_cast<size_t>(k + kk) * UNITS + ju) * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float hk = comp(hv[i], kk);
              acc[i][0] = fmaf(hk, w.x, acc[i][0]);
              acc[i][1] = fmaf(hk, w.y, acc[i][1]);
              acc[i][2] = fmaf(hk, w.z, acc[i][2]);
              acc[i][3] = fmaf(hk, w.w, acc[i][3]);
            }
          }
        }
      }
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            red[(i * 4 + g) * LSTM_HALF + lt] = acc[i][g];
      }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = r0 + rg + 8 * i;
          if (b >= B) continue;
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] =
                xp[i][g] + (acc[i][g] + red[(i * 4 + g) * LSTM_HALF + lt]);
          const size_t o = static_cast<size_t>(b) * H + j;
          const float h_old = __ldcg(h_prev + o);
          const float c_old = __ldcg(c_prev + o);
          const float c_new =
              sigmoidf(pre[1]) * c_old + sigmoidf(pre[0]) * tanhf(pre[2]);
          const float h_new = sigmoidf(pre[3]) * tanhf(c_new);
          const float mi = m[i];
          h_next[o] = mi * h_new + (1.0f - mi) * h_old;
          p.c_last[o] = mi * c_new + (1.0f - mi) * c_old;
          p.out[static_cast<size_t>(t) * B * H + o] = mi * h_new;
        }
      }
      __syncthreads();  // the next tile overwrites Hs and red
    }
    if (t < p.L - 1) grid_sync(p.bar);
  }
}

}  // namespace

// Shapes are checked by the Python wrapper (multimodal_baby_tpu_torch/ops/
// lstm.py): f32 everywhere, contiguous, 16-byte aligned; x_proj [L, B, 4H],
// mask [L, B], w_hh [H, 4H], h0, c0, h_last, c_last [B, H], out [L, B, H],
// hbuf [2, B, H] scratch, bar two zeroed 32-bit words; L >= 1, H % 16 == 0,
// 16 <= H <= 576. Returns the first CUDA error, or 0.
extern "C" int mmb_lstm_f32(const void* xp, const void* mask, const void* whh,
                            const void* h0, const void* c0, void* out,
                            void* h_last, void* c_last, void* hbuf, void* bar,
                            int L, int B, int H, void* stream) {
  const LstmArgs p{static_cast<const float*>(xp),
                   static_cast<const float*>(mask),
                   static_cast<const float*>(whh),
                   static_cast<const float*>(h0),
                   static_cast<const float*>(c0),
                   static_cast<float*>(out),
                   static_cast<float*>(h_last),
                   static_cast<float*>(c_last),
                   static_cast<float*>(hbuf),
                   static_cast<unsigned*>(bar),
                   L,
                   B,
                   H};
  const int tiles_u = H / UNITS;
  const int tiles_r = (B + ROWS - 1) / ROWS;
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lstm_smem(H)));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lstm_kernel, LSTM_THREADS, lstm_smem(H));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every unit tile needs a block; the row tiles are shared among the
  // blocks of a unit tile
  const int groups = per_sm * sms / tiles_u;
  if (groups < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int blocks = tiles_u * (groups < tiles_r ? groups : tiles_r);
  return static_cast<int>(launch_persistent(
      lstm_kernel, p, LSTM_THREADS, static_cast<int>(lstm_smem(H)),
      static_cast<cudaStream_t>(stream), blocks));
}
