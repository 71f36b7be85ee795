// Shared-memory staging for the port's persistent, tile-walking kernels
// (budget_rooms.cu, decide_rooms.cu).
//
// A kernel stages a tile of rows as a few contiguous byte spans, one per
// operand. Each span lands in a "slot" of shared memory at the same
// offset modulo 16 as its global source, so the 16-byte-aligned body of
// any span moves with `cp.async` of 16 bytes (coalesced, no registers
// held while in flight, every copy of the tile in flight at once) and
// only a ragged head and tail of under 16 bytes each move by plain byte
// loads. Slots are 16-byte aligned and `slot_bytes(n)` long. After
// issuing a tile: `commit()`, `wait<0>()`, `__syncthreads()`.
//
// Everything here has internal linkage (an unnamed namespace): each
// kernel's shared library keeps its own copy, and the caches of
// `persistent_blocks` and `max_smem` are never shared with another
// library loaded into the same process.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace staging {
namespace {

// Bytes of a slot that holds an n-byte span at any offset modulo 16.
__host__ __device__ constexpr size_t slot_bytes(size_t n) {
  return (n + 15 + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where span `src` lands in `slot` (the same address for every thread).
template <typename T>
__device__ __forceinline__ T* placed(unsigned char* slot, const void* src) {
  return reinterpret_cast<T*>(slot + (reinterpret_cast<uintptr_t>(src) & 15u));
}

// Start the copy of n bytes at global `src` into `slot`, spread over
// `nthreads` threads (a whole block, or one warp with tid = lane). The
// 16-byte body goes by cp.async (complete after the caller's
// commit()/wait()); the head and tail are stored at once.
__device__ __forceinline__ void stage(unsigned char* slot, const void* src, size_t n,
                                      int tid, int nthreads) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = placed<unsigned char>(slot, src);
  size_t head = (16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u;
  if (head > n) head = n;
  const size_t body = (n - head) & ~static_cast<size_t>(15);
  for (size_t i = head + 16 * static_cast<size_t>(tid); i < head + body;
       i += 16 * static_cast<size_t>(nthreads)) {
    cp_async16(d + i, s + i);
  }
  for (size_t i = tid; i < head; i += nthreads) d[i] = s[i];
  for (size_t i = head + body + tid; i < n; i += nthreads) d[i] = s[i];
}

// Write n bytes from shared `src` to global `dst` with the widest stores
// their common alignment allows (16, 4 or 1 bytes a thread), coalesced
// over `nthreads` threads. Kernels place an output's staging area with
// `placed(slot, dst)` so the body always goes 16 bytes a thread: the
// 4- and 1-byte paths are never taken. They stay because with the 16-byte
// path alone ptxas allocates decide_rooms differently (64 registers and
// 40 bytes of spills, against 56 and none), and it ran 10 % slower at the
// north-star shape on an H100 (PERF.md, kernel_ab.py).
__device__ __forceinline__ void store(void* dst, const void* src, size_t n, int tid,
                                      int nthreads) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const uintptr_t skew = reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(s);
  const size_t g = (skew & 15u) == 0 ? 16 : ((skew & 3u) == 0 ? 4 : 1);
  size_t head = (g - (reinterpret_cast<uintptr_t>(d) & (g - 1))) & (g - 1);
  if (head > n) head = n;
  const size_t body = (n - head) / g * g;
  if (g == 16) {
    for (size_t i = head + 16 * static_cast<size_t>(tid); i < head + body;
         i += 16 * static_cast<size_t>(nthreads)) {
      *reinterpret_cast<uint4*>(d + i) = *reinterpret_cast<const uint4*>(s + i);
    }
  } else if (g == 4) {
    for (size_t i = head + 4 * static_cast<size_t>(tid); i < head + body;
         i += 4 * static_cast<size_t>(nthreads)) {
      *reinterpret_cast<uint32_t*>(d + i) = *reinterpret_cast<const uint32_t*>(s + i);
    }
  } else {
    for (size_t i = head + tid; i < head + body; i += nthreads) d[i] = s[i];
  }
  for (size_t i = tid; i < head; i += nthreads) d[i] = s[i];
  for (size_t i = head + body + tid; i < n; i += nthreads) d[i] = s[i];
}

// The number of persistent blocks for a launch of `kernel`: as many as
// fit on every SM at once with `smem` bytes of dynamic shared memory, no
// more than `tiles`. Raises the kernel's dynamic shared-memory limit first
// when it needs more than the default 48 KB. The device queries run once
// per (device, smem), so a launch captured into a CUDA graph after a
// first launch of the same shape makes none. Returns 0 and sets *err on
// failure.
template <typename Kernel>
__host__ inline int persistent_blocks(Kernel kernel, int threads, size_t smem,
                                      long long tiles, cudaError_t* err) {
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev != cached_dev || smem != cached_smem) {
    cached_dev = -1;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess && smem > 48 * 1024) {
      *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem));
    }
    if (*err == cudaSuccess) {
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (*err != cudaSuccess) return 0;
    if (per_sm < 1) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    cached_dev = dev;
    cached_smem = smem;
  }
  const long long blocks = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(blocks < tiles ? blocks : tiles);
}

// Dynamic shared memory a block may opt into on the current device (0 if
// it cannot be read), queried once per device.
__host__ inline size_t max_smem() {
  static int cached_dev = -1;
  static size_t bytes = 0;
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != cached_dev) {
    if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess) {
      return 0;
    }
    bytes = static_cast<size_t>(value);
    cached_dev = dev;
  }
  return bytes;
}

}  // namespace
}  // namespace staging
