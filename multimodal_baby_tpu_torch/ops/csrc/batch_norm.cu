// K12: BatchNorm on batch statistics for bf16 NHWC activations on Hopper
// (sm_90a), over the pixels flattened to rows, x [M, C] (the NCHW view of
// channels-last data is this layout with no copy), as two launches:
//
//   statistics: mean = sum(x) / M, var = max(sum(x^2) / M - mean^2, 0),
//               mul = weight * rsqrt(var + eps), add = bias - mean * mul
//               ([C] f32), and running_{mean,var} = keep * running
//               + take * {mean, var}, the biased variance (as flax)
//   apply:      out = bf16(relu(x * mul + add [+ r])), r the block's
//               identity (bf16) or its downsample normalised in the same
//               pass, r = d * mul_d + add_d, in f32 with one rounding
//
// Replaces no TPU kernel: the JAX package leaves this BatchNorm to XLA,
// which fuses it; in eager PyTorch it was some twenty passes over f32
// copies of the activation. Added for the frozen ResNeXt-50 trained as the
// published recipe says (frozen_bn "batch"), where the conv path runs 53 of
// them a forward.
//
// What bounds it on an H100: 2 to 4 operations an element against 2 bytes
// read (statistics) and 4 to 6 bytes moved (apply), far below the card's
// ridge, so only the bytes count. Both kernels read and write 16-byte
// vectors of 8 channels, neighbouring threads on neighbouring vectors of
// one row; a block covers a range of up to 128 channels, 256 / (C / 8) rows
// at a time (at least 16). The statistics grid cuts the rows into slabs,
// two blocks an SM in all, 8 loads in flight a thread: each block keeps f32
// sums of x and x^2 per thread, adds them up in shared memory in a fixed
// order and writes one partial row; the last block of each channel range
// (an atomic ticket, reset by that block) adds the partials in a fixed
// order in f64, 8 loads in flight a thread (one at a time, their latency
// was half the pass at the mid-sized shapes), so two calls give the same
// bits and no float atomics are used. The apply grid, four blocks an SM,
// walks the rows with mul and add (and the downsample's) held in
// registers, two rows in flight a thread.

#include "common.cuh"

namespace {

constexpr int BN_THREADS = 256;
constexpr int BN_UNROLL = 8;  // 16-byte loads in flight a thread (stats)
constexpr int BN_FINISH = 8;  // partials in flight a thread (the last block)

struct StatsArgs {
  const uint4* x;   // [M, C / 8]
  long long M;
  int C, cc;        // cc: vector columns a block covers
  long long rows;   // rows a slab (a multiple of 256 / cc)
  float* part;      // [2][slabs][C]: the slabs' sums, then sums of squares
  unsigned* tickets;  // one a channel range, zero between calls
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  float* fold;      // [2][C]: mul, then add
  float eps, keep, take;
};

__device__ __forceinline__ void accumulate(const uint4 raw, float (&s)[8],
                                           float (&q)[8]) {
  float f[8];
  unpack8(raw, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s[e] += f[e];
    q[e] = fmaf(f[e], f[e], q[e]);
  }
}

__global__ void __launch_bounds__(BN_THREADS, 2)
    bn_stats_kernel(const StatsArgs p) {
  __shared__ float red[2 * BN_THREADS * 8];
  __shared__ double fin[2 * BN_THREADS];
  __shared__ bool last;
  const int cols = p.C / 8, cc = p.cc, rpi = BN_THREADS / cc;
  const int nch = cc * 8;  // channels of a full range
  const int tx = threadIdx.x % cc, ty = threadIdx.x / cc;
  const int col = blockIdx.y * cc + tx;
  const bool on = ty < rpi && col < cols;
  float s[8] = {}, q[8] = {};
  const long long r0 = static_cast<long long>(blockIdx.x) * p.rows;
  const long long r1 = min(p.M, r0 + p.rows);
  if (on) {
    const uint4* src = p.x + col;
    long long r = r0 + ty;
    for (; r + (BN_UNROLL - 1) * rpi < r1; r += BN_UNROLL * rpi) {
      uint4 v[BN_UNROLL];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u)
        v[u] = __ldg(src + (r + u * rpi) * cols);
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) accumulate(v[u], s, q);
    }
    for (; r < r1; r += rpi) accumulate(__ldg(src + r * cols), s, q);
    float* rs = red + ty * nch + tx * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      rs[e] = s[e];
      rs[rpi * nch + e] = q[e];
    }
  }
  __syncthreads();
  // the block's partial row: thread i adds the rpi rows of one channel's
  // sum (i < nch) or sum of squares, in row order
  const int c0 = blockIdx.y * nch;
  const int S = gridDim.x;
  for (int i = threadIdx.x; i < 2 * nch; i += BN_THREADS) {
    const int k = i / nch, c = i % nch;
    if (c0 + c >= p.C) continue;
    float t = 0.0f;
    for (int r = 0; r < rpi; ++r) t += red[(k * rpi + r) * nch + c];
    p.part[(static_cast<size_t>(k) * S + blockIdx.x) * p.C + c0 + c] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.tickets + blockIdx.y, 1u) ==
           static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block of the range: g threads a channel add every g-th slab's
  // partials in slab order (BN_FINISH loads in flight, a slab past the
  // last read as 0), then one thread adds the g sums in order
  const int n = min(nch, p.C - c0);
  const int g = BN_THREADS / n;
  const int j = threadIdx.x / n, c = threadIdx.x % n;
  if (j < g) {
    double a = 0.0, b = 0.0;
    const float* ps = p.part + c0 + c;
    for (int sl = j; sl < S; sl += BN_FINISH * g) {
      float pa[BN_FINISH], pb[BN_FINISH];
#pragma unroll
      for (int u = 0; u < BN_FINISH; ++u) {
        const int at = sl + u * g;
        pa[u] = at < S ? __ldcg(ps + static_cast<size_t>(at) * p.C) : 0.0f;
        pb[u] = at < S ? __ldcg(ps + (static_cast<size_t>(S) + at) * p.C)
                       : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < BN_FINISH; ++u) {
        a += pa[u];
        b += pb[u];
      }
    }
    fin[2 * threadIdx.x] = a;
    fin[2 * threadIdx.x + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    double a = 0.0, b = 0.0;
    for (int k = 0; k < g; ++k) {
      a += fin[2 * (k * n + c)];
      b += fin[2 * (k * n + c) + 1];
    }
    const double M = static_cast<double>(p.M);
    const double mean = a / M;
    const double var = fmax(b / M - mean * mean, 0.0);
    const int ch = c0 + c;
    const double mul = static_cast<double>(p.weight[ch]) /
                       sqrt(var + static_cast<double>(p.eps));
    p.fold[ch] = static_cast<float>(mul);
    p.fold[p.C + ch] =
        static_cast<float>(static_cast<double>(p.bias[ch]) - mean * mul);
    // the plain path's f32 update: running * keep + take * batch
    p.running_mean[ch] =
        __fadd_rn(__fmul_rn(p.running_mean[ch], p.keep),
                  __fmul_rn(p.take, static_cast<float>(mean)));
    p.running_var[ch] = __fadd_rn(__fmul_rn(p.running_var[ch], p.keep),
                                  __fmul_rn(p.take, static_cast<float>(var)));
  }
  if (threadIdx.x == 0) atomicExch(p.tickets + blockIdx.y, 0u);
}

struct ApplyArgs {
  const uint4* x;  // [M, C / 8]
  const uint4* r;  // the identity or the downsample's input, or null
  const float* fold;    // [2][C]: mul, then add
  const float* fold_r;  // the downsample's (RESIDUAL == 2)
  uint4* out;
  long long M;
  int C, cc;
};

__device__ __forceinline__ void load8f(const float* src, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// RESIDUAL: 0 none, 1 the identity, 2 the downsample normalised here
template <int RESIDUAL>
__device__ __forceinline__ uint4 apply8(const uint4 xv, const uint4 rv,
                                        const float (&m)[8],
                                        const float (&a)[8],
                                        const float (&mr)[8],
                                        const float (&ar)[8]) {
  float f[8], g[8];
  unpack8(xv, f);
  if (RESIDUAL) unpack8(rv, g);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float v = fmaf(f[e], m[e], a[e]);
    if (RESIDUAL == 1) v += g[e];
    if (RESIDUAL == 2) v += fmaf(g[e], mr[e], ar[e]);
    f[e] = v < 0.0f ? 0.0f : v;  // a NaN passes, as torch.relu's
  }
  return pack8(f);
}

template <int RESIDUAL>
__global__ void __launch_bounds__(BN_THREADS, 4)
    bn_apply_kernel(const ApplyArgs p) {
  const int cols = p.C / 8, cc = p.cc, rpi = BN_THREADS / cc;
  const int tx = threadIdx.x % cc, ty = threadIdx.x / cc;
  const int col = blockIdx.y * cc + tx;
  if (ty >= rpi || col >= cols) return;
  float m[8], a[8], mr[8] = {}, ar[8] = {};
  load8f(p.fold + col * 8, m);
  load8f(p.fold + p.C + col * 8, a);
  if (RESIDUAL == 2) {
    load8f(p.fold_r + col * 8, mr);
    load8f(p.fold_r + p.C + col * 8, ar);
  }
  const long long step = static_cast<long long>(gridDim.x) * rpi;
  long long r = static_cast<long long>(blockIdx.x) * rpi + ty;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // two rows a trip: both rows' loads before either row's arithmetic
  for (; r + step < p.M; r += 2 * step) {
    const long long i0 = r * cols + col, i1 = (r + step) * cols + col;
    const uint4 x0 = __ldcs(p.x + i0), x1 = __ldcs(p.x + i1);
    const uint4 r0 = RESIDUAL ? __ldcs(p.r + i0) : zero;
    const uint4 r1 = RESIDUAL ? __ldcs(p.r + i1) : zero;
    p.out[i0] = apply8<RESIDUAL>(x0, r0, m, a, mr, ar);
    p.out[i1] = apply8<RESIDUAL>(x1, r1, m, a, mr, ar);
  }
  if (r < p.M) {
    const long long i0 = r * cols + col;
    const uint4 r0 = RESIDUAL ? __ldcs(p.r + i0) : zero;
    p.out[i0] = apply8<RESIDUAL>(__ldcs(p.x + i0), r0, m, a, mr, ar);
  }
}

}  // namespace

// Shapes, alignment and the grid are checked and chosen by the Python
// wrapper (multimodal_baby_tpu_torch/ops/batch_norm.py::
// batch_norm_geometry): C % 8 == 0, M >= 1, every pointer 16-byte aligned,
// part holding 2 * slabs * C floats, tickets one zero word a channel range,
// fold 2 * C floats.
// Each returns the launch's CUDA error, or 0.
extern "C" int mmb_batch_norm_stats_bf16(
    const void* x, long long M, int C, int cc, int slabs, long long rows,
    void* part, void* tickets, const void* weight, const void* bias,
    void* running_mean, void* running_var, void* fold, float eps, float keep,
    float take, void* stream) {
  const StatsArgs p{static_cast<const uint4*>(x), M, C, cc, rows,
                    static_cast<float*>(part),
                    static_cast<unsigned*>(tickets),
                    static_cast<const float*>(weight),
                    static_cast<const float*>(bias),
                    static_cast<float*>(running_mean),
                    static_cast<float*>(running_var),
                    static_cast<float*>(fold), eps, keep, take};
  const int chunks = (C / 8 + cc - 1) / cc;
  bn_stats_kernel<<<dim3(slabs, chunks), BN_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// residual: 0 none, 1 r is the identity, 2 r is the downsample's input,
// normalised with fold_r
extern "C" int mmb_batch_norm_apply_bf16(
    const void* x, const void* r, const void* fold, const void* fold_r,
    void* out, long long M, int C, int cc, int grid, int residual,
    void* stream) {
  const ApplyArgs p{static_cast<const uint4*>(x), static_cast<const uint4*>(r),
                    static_cast<const float*>(fold),
                    static_cast<const float*>(fold_r),
                    static_cast<uint4*>(out), M, C, cc};
  const dim3 blocks(grid, (C / 8 + cc - 1) / cc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (residual == 0)
    bn_apply_kernel<0><<<blocks, BN_THREADS, 0, s>>>(p);
  else if (residual == 1)
    bn_apply_kernel<1><<<blocks, BN_THREADS, 0, s>>>(p);
  else
    bn_apply_kernel<2><<<blocks, BN_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
