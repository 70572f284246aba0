// The masked LSTM recurrence (K9) on Hopper (sm_90a): f32 in and out, the
// products on the tensor cores as three TF32 products (mma_tf32.cuh). For
// t = 0 .. L-1, with gates in the order i, f, g, o,
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
// product is spread over the card in one persistent cooperative launch per
// sequence. Block (unit tile u, row group g) owns 16 hidden units: their four
// gate columns of W_hh stay in shared memory for the whole sequence, laid
// out as the A fragments of m16n8k8 (one 16-byte load a fragment), and for
// each tile of 32 batch rows of its group it takes h_{t-1} [32, H] from L2
// into shared memory (cp.async.cg in four K chunks, the products starting on
// the first), computes the 64 x 32 gate sums (16 warps: warp w takes gate
// w % 4, all 32 rows (four n8 tiles: W's fragment read and split once for
// four mma) and the k steps ks = w / 4 mod 4; four warps a sub-partition
// and four accumulators a warp hide the mma's latency; each W and h element
// split into TF32 hi and lo as it is read; the four phases' sums s added as
// (s0 + s1) + (s2 + s3) in shared memory), and each of the 512 threads
// applies the gates to one (row, unit) pair, c carried in c_last by the
// thread that owns it and loaded, with x_proj and the mask, before the
// step's wait. Single-pass TF32 would put out 6e-5 from the f32 scan at
// CVCL's shape; the split keeps it near 1e-7.
//
// The rows of an LSTM do not mix, so a row tile needs only the 16-unit
// slices of its own row tile from the H / 16 blocks that compute them: no
// grid barrier. Each (row tile, unit tile) has a flag, set to t + 1 (a
// release store, gpu scope, after a __syncthreads) once its h_t is stored,
// before the thread that sets it loads the next step's inputs; a step waits,
// one thread per unit tile, for its row tile's flags to reach t
// (ld.acquire), after loading its own x_proj and mask. The flags live in a
// buffer the caller keeps per stream (zeroed once); the last block to finish
// sets them back to zero, so a call needs no fill launch and two calls on
// two streams use two buffers. The launch's set-up (attribute, occupancy,
// SM count) is queried once per device (grid.cuh::LaunchCache).
//
// What bounds it on an H100: the step latency. At CVCL's B = 128, H = 512 a
// step is 268 MFLOP of f32 products (805 MFLOP as three TF32 products,
// about 1.6 us at the 495 TFLOP/s TF32 peak) spread over 128 blocks, plus
// the flags' round trip and an L2 read of h (8 MB over all blocks) per
// step; the 25 or 64 steps are dependent.

#include "common.cuh"
#include "grid.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int K9_THREADS = 512;  // one (row, unit) pair a thread
constexpr int UNITS = 16;  // hidden units per block: 64 gate columns
constexpr int ROWS = 32;   // batch rows per tile
constexpr int CHUNKS = 4;  // the h copy's K chunks
constexpr int MAX_H = 576;
constexpr int FLAGS0 = 32;  // sync words: [0] the exit count, flags from 32
// a set of gate sums: [gate][row][unit] with rows CS_PITCH floats apart,
// which puts an accumulator fragment's 32 stores on 32 banks
constexpr int CS_PITCH = 20;
constexpr int CS_FLOATS = 4 * ROWS * CS_PITCH;
// polls of a flag before the kernel gives up with an error (seconds)
constexpr unsigned SPIN_LIMIT = 1u << 26;

struct LstmArgs {
  const float *xp, *mask, *whh, *h0, *c0;
  float *out, *h_last, *c_last, *hbuf;  // hbuf: two [B, H] buffers
  unsigned* sync;  // zero on entry, left zero: exit count, then flags
  int L, B, H;
  int groups;      // row groups (blocks per unit tile)
};

// W_hh's fragments, the h tile (at least the room of one set of gate
// sums, which it holds after the products), a set of gate sums: floats
__host__ __device__ constexpr size_t k9_smem_floats(int H) {
  return static_cast<size_t>(H) * UNITS * 4 +
         (ROWS * (H + 4) > CS_FLOATS ? ROWS * (H + 4) : CS_FLOATS) +
         CS_FLOATS;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Issue the cp.async copies of chunk c of h_prev's rows [r0, r0 + 32) into
// Hs (rows past B are zero-filled) and commit them as one group.
__device__ __forceinline__ void copy_h_chunk(float* Hs, const float* h_prev,
                                             int r0, int B, int H, int c) {
  const int KS = H / 8;
  const int col0 = 8 * (c * KS / CHUNKS);
  const int n4 = (8 * ((c + 1) * KS / CHUNKS) - col0) / 4;
  const int S = H + 4;
  for (int e = threadIdx.x; e < ROWS * n4; e += K9_THREADS) {
    const int row = e / n4;
    const int k = col0 + 4 * (e % n4);
    const int b = r0 + row;
    cp_async16(Hs + row * S + k,
               h_prev + static_cast<size_t>(b < B ? b : 0) * H + k, b < B);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(K9_THREADS, 1)
    lstm_kernel(const LstmArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_block;
  const int H = p.H;
  const int B = p.B;
  const int S = H + 4;  // the h tile's pitch: the B fragments' 32 lanes on
                        // 32 banks (S % 32 is 4 or 20)
  const int KS = H / 8;
  float* Ws = smem;                                     // [4][KS][32][4]
  float* Hs = Ws + static_cast<size_t>(H) * UNITS * 4;  // [ROWS][S]
  float* Cs = Hs + (ROWS * S > CS_FLOATS ? ROWS * S : CS_FLOATS);

  const int tiles_u = H / UNITS;
  const int tiles_r = (B + ROWS - 1) / ROWS;
  const int ut = blockIdx.x % tiles_u;
  const int group = blockIdx.x / tiles_u;
  const int j0 = ut * UNITS;
  unsigned* flags = p.sync + FLAGS0;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fg = lane / 4;  // fragment row group
  const int fq = lane % 4;  // fragment thread in group
  const int gate = warp % 4;  // this warp's m16 tile: one gate
  const int kq = warp / 4;    // its k steps: ks % 4 == kq
  // the gates' pair: unit gu of row gr
  const int gu = tid % UNITS;
  const int gr = tid / UNITS;
  const int j = j0 + gu;

  // this block's gate columns, once, as A fragments: for gate g and k
  // step ks, lane l holds W(k0 + q, u), W(k0 + q, u + 8), W(k0 + q + 4, u),
  // W(k0 + q + 4, u + 8) with u = l / 4, q = l % 4, W(k, u) = W_hh[k,
  // g H + j0 + u]
  for (int e = tid; e < H * 16; e += K9_THREADS) {
    const int k = e / 16;
    const int g = (e / 4) % 4;
    const int u4 = 4 * (e % 4);
    const float4 w = __ldg(reinterpret_cast<const float4*>(
        p.whh + static_cast<size_t>(k) * 4 * H + g * H + j0 + u4));
    const float wv[4] = {w.x, w.y, w.z, w.w};
    const int ks = k / 8;
    const int kk = k % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = u4 + i;
      const int slot = 2 * (kk / 4) + u / 8;
      const int l = 4 * (u % 8) + kk % 4;
      Ws[((static_cast<size_t>(g) * KS + ks) * 32 + l) * 4 + slot] = wv[i];
    }
  }

  // the (t, row tile) pairs of this block, in order: row tiles group,
  // group + groups, ... of each step
  const int my_tiles =
      group < tiles_r ? (tiles_r - group + p.groups - 1) / p.groups : 0;
  const int iters = p.L * my_tiles;

  // x_proj, mask and c of pair `it` for this thread's row, loaded before
  // the pair's wait (c: after the previous pair's gates, which may have
  // written it)
  float xp[4], m = 0.0f, cv = 0.0f;
  auto row_of = [&](int it) {
    const int b = (group + (it % my_tiles) * p.groups) * ROWS + gr;
    return b < B ? b : 0;
  };
  auto prefetch = [&](int it) {
    const size_t row = static_cast<size_t>(it / my_tiles) * B + row_of(it);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xp[g] = __ldg(p.xp + row * 4 * H + g * H + j);
    m = __ldg(p.mask + row);
  };
  auto load_c = [&](int it) {
    const size_t o = static_cast<size_t>(row_of(it)) * H + j;
    cv = it < my_tiles ? __ldg(p.c0 + o) : p.c_last[o];
  };
  if (iters > 0) {
    prefetch(0);
    load_c(0);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const int t = it / my_tiles;
    const int rt = group + (it % my_tiles) * p.groups;
    const int r0 = rt * ROWS;
    const float* h_prev =
        t == 0 ? p.h0 : p.hbuf + static_cast<size_t>((t - 1) & 1) * B * H;
    float* h_next = t == p.L - 1 ? p.h_last
                                 : p.hbuf + static_cast<size_t>(t & 1) * B * H;

    // step t: wait for h_{t-1}
    if (t > 0 && tid < tiles_u) {
      const unsigned* f = flags + rt * tiles_u + tid;
      for (unsigned spin = 0; static_cast<int>(ld_acquire(f)) < t; ++spin)
        if (spin == SPIN_LIMIT) __trap();  // a flag that never comes
    }
    __syncthreads();
    // the wait is over
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) copy_h_chunk(Hs, h_prev, r0, B, H, c);

    float acc[4][4], cor[4][4];  // the tile's four n8 tiles
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = cor[n][i] = 0.0f;
    float h_old = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (c == 0) cp_async_wait<CHUNKS - 1>();
      if (c == 1) cp_async_wait<CHUNKS - 2>();
      if (c == 2) cp_async_wait<CHUNKS - 3>();
      if (c == 3) cp_async_wait<0>();
      __syncthreads();
      if (c == 0) {
        // the first chunk of h_{t-1} is in
      }
      if (c == CHUNKS - 1) h_old = Hs[gr * S + j];  // Hs is reused below
      const int lo = c * KS / CHUNKS;
      const int ks_end = (c + 1) * KS / CHUNKS;
      for (int ks = lo + (kq - lo % 4 + 4) % 4; ks < ks_end; ks += 4) {
        const float4 a = *reinterpret_cast<const float4*>(
            Ws + ((static_cast<size_t>(gate) * KS + ks) * 32 + lane) * 4);
        uint32_t ahi[4], alo[4];
        split_tf32(a.x, ahi[0], alo[0]);
        split_tf32(a.y, ahi[1], alo[1]);
        split_tf32(a.z, ahi[2], alo[2]);
        split_tf32(a.w, ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* hrow = Hs + (8 * n + fg) * S + 8 * ks + fq;
          uint32_t bhi[2], blo[2];
          split_tf32(hrow[0], bhi[0], blo[0]);
          split_tf32(hrow[4], bhi[1], blo[1]);
          mma_3xtf32(acc[n], cor[n], ahi, alo, bhi, blo);
        }
      }
    }
    // the products are in
    // the gate sums to shared memory as (s0 + s1) + (s2 + s3) for the k
    // phases' sums s: phases 1 and 3 store theirs (in Hs's room and in
    // Cs), then phases 0 and 2 add theirs in front
    __syncthreads();  // every warp is done with Hs
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if (kq % 2 == 1 - round) {
        float* sums = kq < 2 ? Hs : Cs;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* at = sums + (gate * ROWS + 8 * n + 2 * fq + i % 2) *
                                   CS_PITCH + fg + 8 * (i / 2);
            const float v = acc[n][i] + cor[n][i];
            *at = round == 0 ? v : v + *at;
          }
      }
      __syncthreads();
    }
    // the gate sums are in shared memory
    const int b = r0 + gr;
    if (b < B) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int at = (g * ROWS + gr) * CS_PITCH + gu;
        pre[g] = xp[g] + (Hs[at] + Cs[at]);
      }
      const size_t o = static_cast<size_t>(b) * H + j;
      const float c_new =
          sigmoidf(pre[1]) * cv + sigmoidf(pre[0]) * tanhf(pre[2]);
      const float h_new = sigmoidf(pre[3]) * tanhf(c_new);
      // this thread's h, c and out
      h_next[o] = m * h_new + (1.0f - m) * h_old;
      p.c_last[o] = m * c_new + (1.0f - m) * cv;
      p.out[static_cast<size_t>(t) * B * H + o] = m * h_new;
    }
    __syncthreads();  // every h_t of the tile stored; Hs and Cs free
    // this step's h is out
    if (tid == 0 && t < p.L - 1)  // release: after the block's stores
      st_release(flags + rt * tiles_u + ut, static_cast<unsigned>(t + 1));
    if (it + 1 < iters) {  // the next pair's inputs, before its wait
      prefetch(it + 1);
      load_c(it + 1);
    }
  }

  // the last block out sets the flags and the count back to zero
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(p.sync, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (last_block) {
    for (int e = tid; e < tiles_r * tiles_u; e += K9_THREADS) flags[e] = 0u;
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicExch(p.sync, 0u);
    }
  }
}

}  // namespace

// Shapes are checked by the Python wrapper (multimodal_baby_tpu_torch/ops/
// lstm.py): f32 everywhere, contiguous, 16-byte aligned; x_proj [L, B, 4H],
// mask [L, B], w_hh [H, 4H], h0, c0, h_last, c_last [B, H], out [L, B, H],
// hbuf [2, B, H] scratch, sync 32 + ceil(B / 32) H / 16 32-bit words, zero
// (and left zero), not used by another call at the same time; L >= 1,
// H % 16 == 0, 16 <= H <= 576. Returns the first CUDA error, or 0.
extern "C" int mmb_lstm_f32(const void* xp, const void* mask, const void* whh,
                            const void* h0, const void* c0, void* out,
                            void* h_last, void* c_last, void* hbuf, void* sync,
                            int L, int B, int H, void* stream) {
  static LaunchCache cache;
  const int smem = static_cast<int>(k9_smem_floats(H) * sizeof(float));
  const int max_smem =
      static_cast<int>(k9_smem_floats(MAX_H) * sizeof(float));
  int on_card = 0;
  cudaError_t err = cache.blocks(lstm_kernel, K9_THREADS, smem, max_smem,
                                 false, &on_card);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every unit tile needs a block; the row tiles are shared among the
  // blocks of a unit tile
  const int tiles_u = H / UNITS;
  const int tiles_r = (B + ROWS - 1) / ROWS;
  int groups = on_card / tiles_u;
  if (groups < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (groups > tiles_r) groups = tiles_r;
  const LstmArgs p{static_cast<const float*>(xp),
                   static_cast<const float*>(mask),
                   static_cast<const float*>(whh),
                   static_cast<const float*>(h0),
                   static_cast<const float*>(c0),
                   static_cast<float*>(out),
                   static_cast<float*>(h_last),
                   static_cast<float*>(c_last),
                   static_cast<float*>(hbuf),
                   static_cast<unsigned*>(sync),
                   L,
                   B,
                   H,
                   groups};
  return static_cast<int>(launch_cooperative(
      lstm_kernel, p, tiles_u * groups, K9_THREADS, smem,
      static_cast<cudaStream_t>(stream)));
}
