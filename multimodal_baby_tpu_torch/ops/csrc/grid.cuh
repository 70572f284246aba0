// A grid-wide barrier for the port's persistent cooperative kernels
// (stage.cu, vit_block.cu, infonce.cu), and their launches. The launch
// (cudaLaunchCooperativeKernel, as many blocks as fit on the card at once)
// makes every block resident, which the barrier needs. Writes made before
// it are visible to every block after it, as long as the reads after it go
// through L2 (cp.async.cg, __ldcg): a plain load could hit a stale line of
// the reading SM's L1.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>

namespace {

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// thread 0's part of the barrier: arrive, and wait for every block's
// arrival. bar: two zeroed words, arrivals and generation
__device__ __forceinline__ void grid_arrive_wait(unsigned* bar) {
  if (threadIdx.x == 0) {
    const unsigned gen = load_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (load_acquire(bar + 1) == gen) __nanosleep(64);
    }
    __threadfence();
  }
}

// bar: as grid_arrive_wait
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __threadfence();
  __syncthreads();
  grid_arrive_wait(bar);
  __syncthreads();
}

// Launch `kernel` cooperatively with as many blocks of `threads` as fit on
// the card at once with `smem` bytes of dynamic shared memory each, and at
// most `max_blocks`.
template <class Kernel, class Args>
cudaError_t launch_persistent(Kernel kernel, const Args& args, int threads,
                              int smem, cudaStream_t stream,
                              int max_blocks = 1 << 30) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<Args*>(&args)};
  const int grid = per_sm * sms < max_blocks ? per_sm * sms : max_blocks;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(threads),
                                     params, smem, stream);
}

// What a launcher of K9 or K4 asks the runtime once per device instead of
// at every call: the kernel's attributes (the dynamic shared memory it may
// take, and clusters of more than 8 blocks where it runs in them) and, per
// shared-memory size, how many of its blocks fit on the card at once.
class LaunchCache {
 public:
  // Blocks of `kernel` resident at once on the current device with
  // `threads` threads and `smem` bytes each; the attributes are set, with
  // `max_smem` bytes, at the first call on a device.
  template <class Kernel>
  cudaError_t blocks(Kernel kernel, int threads, int smem, int max_smem,
                     bool big_clusters, int* out) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mutex_);
    auto sms = sms_.find(device);
    if (sms == sms_.end()) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
      if (err == cudaSuccess && big_clusters)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      int n = 0;
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err != cudaSuccess) return err;
      sms = sms_.emplace(device, n).first;
    }
    const long long key = (static_cast<long long>(device) << 32) | smem;
    auto hit = per_card_.find(key);
    if (hit == per_card_.end()) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
      if (err != cudaSuccess) return err;
      hit = per_card_.emplace(key, per_sm * sms->second).first;
    }
    *out = hit->second;
    return cudaSuccess;
  }

 private:
  std::mutex mutex_;
  std::unordered_map<int, int> sms_;             // device -> SM count
  std::unordered_map<long long, int> per_card_;  // (device, smem) -> blocks
};

// A cooperative launch of `grid` blocks (all resident: see LaunchCache)
template <class Kernel, class Args>
cudaError_t launch_cooperative(Kernel kernel, const Args& args, int grid,
                               int threads, int smem, cudaStream_t stream) {
  void* params[] = {const_cast<Args*>(&args)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(threads), params, smem,
                                     stream);
}

}  // namespace
