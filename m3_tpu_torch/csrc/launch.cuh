// Launch helpers shared by the port's CUDA sources (ops/csrc/lane_aggregates.cu,
// query/functions/csrc/temporal_fused.cu, query/functions/csrc/grouped_reduce.cu,
// parallel/csrc/resident_assembly.cu): the shared memory a block may use,
// the size of a persistent grid (and a kernel's shared memory limit), and
// cp.async copies into shared memory. Only kSmemMax is seen by the host C++
// builds of those sources.

#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <mutex>
#endif

namespace m3 {

// Dynamic shared memory a block may opt into on sm_90 (227 KiB).
constexpr size_t kSmemMax = 232448;

#ifdef __CUDACC__
// The work of resident_blocks, below.
template <class Kernel>
cudaError_t resident_blocks_query(Kernel kernel, int threads, size_t smem, int64_t* out) {
  struct Entry { const void* k; int dev, threads; size_t smem; int64_t blocks; };
  struct Limit { const void* k; int dev; size_t smem; };
  static Entry cache[64];
  static Limit limits[64];
  static int used = 0, nlimits = 0;
  static std::mutex lock;  // ctypes calls run without the GIL
  const std::lock_guard<std::mutex> hold(lock);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Limit* lim = nullptr;
  for (int i = 0; i < nlimits; ++i)
    if (limits[i].k == (const void*)kernel && limits[i].dev == dev) lim = &limits[i];
  if (lim == nullptr || lim->smem < smem) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    if (lim != nullptr) lim->smem = smem;
    else if (nlimits < 64) limits[nlimits++] = {(const void*)kernel, dev, smem};
  }
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.k == (const void*)kernel && c.dev == dev && c.threads == threads && c.smem == smem) {
      *out = c.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  *out = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (used < 64) cache[used++] = {(const void*)kernel, dev, threads, smem, *out};
  return cudaSuccess;
}

// Raises `kernel`'s dynamic shared memory limit to at least `smem` (the
// attribute is the kernel's and only ever grows, so a launch of any size
// seen before stays allowed) and returns the blocks the card holds at once
// (SMs x blocks per SM) at this block size and shared memory. Both are
// looked up once per kernel, device and shape, not on every launch. A
// failed query is also taken off the runtime's last error, so that a later
// launch's cudaGetLastError() does not report it again.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int64_t* out) {
  const cudaError_t e = resident_blocks_query(kernel, threads, smem, out);
  if (e != cudaSuccess) (void)cudaGetLastError();
  return e;
}

// One asynchronous copy of 16 bytes (bypassing L1) or of 4 bytes from
// device memory into shared memory; `smem` and `gmem` aligned to the size.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
// Closes this thread's group of the copies started since the last commit.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits until at most N of this thread's newest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

}  // namespace m3
