// Host-side launch helpers shared by the kernels (bucketize.cu, unpack.cu,
// topk.cu): a kernel's per-device facts read once and cached, the opt-in to
// more than 48 KB of shared memory made once, and the persistent grid of a
// kernel that stages shared data. A launch that finds its facts cached makes
// one runtime call here (cudaGetDevice).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace repro {

constexpr int kMaxDevices = 64;
constexpr size_t kSmemNoOptIn = 48 * 1024;  // bytes a block has without opt-in

// What a launch of kKernel needs to know of one device, read once: SMs,
// blocks an SM keeps resident by threads and registers (at the block size of
// the first call), the shared memory of an SM and the part reserved per
// block, and the dynamic bytes the kernel has opted in to.
template <auto kKernel>
struct KernelCache {
  std::mutex mu;
  std::atomic<bool> ready[kMaxDevices];
  int sms[kMaxDevices];
  int per_sm[kMaxDevices];
  int smem_per_sm[kMaxDevices];
  int reserved[kMaxDevices];
  std::atomic<size_t> opted[kMaxDevices];

  static KernelCache& get() {
    static KernelCache cache;
    return cache;
  }
};

// The cache of kKernel for the current device, filled on its first call.
template <auto kKernel>
cudaError_t kernel_facts(int threads, KernelCache<kKernel>** out, int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  KernelCache<kKernel>& c = KernelCache<kKernel>::get();
  *out = &c;
  const int d = *dev;
  if (c.ready[d].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(c.mu);
  if (c.ready[d].load(std::memory_order_relaxed)) return cudaSuccess;
  int sms = 0, per_sm = 0, smem_sm = 0, reserved = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    d)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, d)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &reserved, cudaDevAttrReservedSharedMemoryPerBlock, d)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kKernel, threads, 0)) != cudaSuccess)
    return err;
  c.sms[d] = sms;
  c.per_sm[d] = per_sm < 1 ? 1 : per_sm;
  c.smem_per_sm[d] = smem_sm;
  c.reserved[d] = reserved;
  c.ready[d].store(true, std::memory_order_release);
  return cudaSuccess;
}

// Let kKernel launch with `smem` dynamic bytes on the current device: opts in
// (cudaFuncSetAttribute) only when the block's `static_smem` + `smem` pass
// 48 KB, once for the largest size asked.
template <auto kKernel>
cudaError_t opt_in(KernelCache<kKernel>& c, int dev, size_t smem,
                   size_t static_smem) {
  if (static_smem + smem <= kSmemNoOptIn ||
      smem <= c.opted[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  std::lock_guard<std::mutex> lock(c.mu);
  if (smem <= c.opted[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  c.opted[dev].store(smem, std::memory_order_release);
  return cudaSuccess;
}

// Blocks of kKernel (no static shared memory) an SM keeps resident at `smem`
// dynamic bytes a block: the cached limit by threads and registers, then by
// shared memory.
template <auto kKernel>
int64_t resident_per_sm(const KernelCache<kKernel>& c, int dev, size_t smem) {
  const size_t per_block = (smem + c.reserved[dev] + 127) / 128 * 128;
  int64_t per_sm = c.per_sm[dev];
  const int64_t by_smem =
      static_cast<int64_t>(c.smem_per_sm[dev]) / static_cast<int64_t>(per_block);
  if (by_smem < per_sm) per_sm = by_smem < 1 ? 1 : by_smem;
  return per_sm;
}

// Size a persistent grid of kKernel, launched at `threads` a block with `smem`
// dynamic bytes, for `blocks` blocks of work: at most as many as the card
// keeps resident, so each block stages its shared data once.
template <auto kKernel>
cudaError_t smem_grid(int threads, size_t smem, int64_t blocks,
                      unsigned* grid_out) {
  KernelCache<kKernel>* c = nullptr;
  int dev = 0;
  cudaError_t err = kernel_facts<kKernel>(threads, &c, &dev);
  if (err != cudaSuccess) return err;
  if ((err = opt_in<kKernel>(*c, dev, smem, 0)) != cudaSuccess) return err;
  const int64_t resident =
      static_cast<int64_t>(c->sms[dev]) * resident_per_sm<kKernel>(*c, dev,
                                                                    smem);
  int64_t grid = blocks < resident ? blocks : resident;
  if (grid < 1) grid = 1;
  *grid_out = static_cast<unsigned>(grid);
  return cudaSuccess;
}

}  // namespace repro
