// Device helpers of the two long-path walks (segment_traceback.cu,
// wf_traceback.cu): a walker thread and producer warps that fill a ring
// of tiles in shared memory, talking through a 64-bit mailbox a slot
// (the walker's requests) and a tile number a slot (the producers'
// answers).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk_tiles {

constexpr int kMaxSlots = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull - 1;  // no request yet
constexpr unsigned long long kDone = ~0ull;      // the walker has finished

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];" : "=l"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

// A request publishes nothing but its own value, and the walker has used
// every entry it read from the slot's old tile before it asks for a new
// one there (the new tile follows from those entries), so the store
// needs no release fence: a fence would wait for the walker's stores of
// runs to device memory.
__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.cta.shared.b64 [%0], %1;" ::"r"(smem_addr(p)), "l"(v) : "memory");
}

// A tile entry by its shared address. Volatile, with a memory clobber:
// the compiler may neither hoist it above the acquire of the tile's
// number (ld_acquire) nor reuse an earlier load of the same address,
// which a slot's next tile refills.
__device__ __forceinline__ int ld_shared_u16(unsigned addr) {
  int v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int ld_shared_s32(unsigned addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

constexpr int kMaxDevices = 64;

// Let `kernel` take `bytes` of dynamic shared memory on the current
// device: cudaFuncSetAttribute once a device and size (the call costs
// host time on every launch otherwise). `allowed` (kMaxDevices entries)
// is the caller's record of the sizes set, one record for each kernel:
// a size set for one kernel must not skip the call for another (the
// loader merges the statics of an inline function across the libraries
// of a process, so the record is never a static of this header).
static cudaError_t allow_smem(const void* kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

// log2 of the tile rows for a segment of NS rows: about a quarter of the
// segment, a power of two, at most 1 << cap_log (a walker crosses
// several tiles a segment, so the tiles below it load while it walks)
inline int tile_rows_log(int NS, int cap_log) {
  int l = 0;
  while (l < cap_log && (2 << l) <= NS / 4) ++l;
  return l;
}

}  // namespace walk_tiles
