// Latency probe: one thread's chain of dependent operations, the
// yardstick of the walks' and the step probes' chain bounds
// (chip_smoke.py phase 16): a long-path walk's longest walker's hops,
// each at least one shared-memory load and the hop's dependent ALU
// instructions; the dense traceback's longest walker's round trips,
// each at least one device-memory load that misses L2; a step of the
// step probes (csrc/probe_step.cu), at least its neighbour exchange (a
// shuffle or a shared-memory load), its dependent ALU instructions and
// its block's barrier.
//
// Replaces no TPU kernel. Plain twin: none (it computes nothing to
// check); allwave_tpu_torch/probes/latency.py times it.
//
// What bounds it on an H100: the latency of one operation, n times in a
// row, on one thread of one SM: kind 0 shared-memory loads (a pointer
// chase round a ring of 256 words, each load's address the last one's
// value), kind 1 integer adds and xors taken in turn (2n operations,
// each reading the last one's result; ptxas merges neither pair into one
// instruction); kind 2 shuffles on one warp (shfl.sync.up, each lane
// shuffling the value it was last handed); kind 3 bar.sync of a block
// of `threads` threads, nothing between two; and `dram_kernel`,
// device-memory loads (a pointer
// chase through a buffer several times the L2, ld.global.cg so L1 serves
// none, each entry the index of the next, never the same 32-byte sector
// twice in a chain; the caller flushes L2 first). Volatile inline PTX
// keeps every operation; the result goes to *sink so nothing is
// dropped. Two lengths timed apart take the launch out.

#include <cuda_runtime.h>

namespace {

__global__ void latency_kernel(int kind, int n, int* sink) {
  __shared__ unsigned ring[256];
  if (kind == 2) {
    unsigned v = threadIdx.x + (unsigned)n;
#pragma unroll 8
    for (int k = 0; k < n; ++k)
      asm volatile("shfl.sync.up.b32 %0, %0, 1, 0, 0xffffffff;" : "+r"(v));
    if (threadIdx.x == 0) sink[0] = (int)v;
    return;
  }
  if (kind == 3) {
#pragma unroll 8
    for (int k = 0; k < n; ++k) asm volatile("bar.sync 0;" ::: "memory");
    if (threadIdx.x == 0) sink[0] = n;
    return;
  }
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  for (int i = 0; i < 256; ++i) ring[i] = base + 4u * ((i + 1) & 255);
  __syncthreads();
  unsigned v = kind == 0 ? base : (unsigned)n;
  if (kind == 0) {
#pragma unroll 8
    for (int k = 0; k < n; ++k) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(v));
  } else {
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      asm volatile("add.s32 %0, %0, %1;" : "+r"(v) : "r"(k));
      asm volatile("xor.b32 %0, %0, %1;" : "+r"(v) : "r"(n));
    }
  }
  sink[0] = (int)v;
}

// n dependent loads from buf, from index start on: each loads the index
// of the next
__global__ void dram_kernel(const unsigned* buf, unsigned start, int n, int* sink) {
  unsigned v = start;
#pragma unroll 4
  for (int k = 0; k < n; ++k)
    asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(v) : "l"(buf + v) : "memory");
  sink[0] = (int)v;
}

}  // namespace

extern "C" {

// n dependent operations of one kind on one block: 0 shared-memory
// loads and 1 adds and xors in turn (2n of them) on one thread, 2
// shuffles on one warp, 3 barriers of `threads` threads (a multiple of
// 32, at most 1024); sink (1,) int32.
int allwave_probe_latency(int kind, int n, int threads, void* sink, void* stream) {
  const int block = kind == 3 ? threads : kind == 2 ? 32 : 1;
  if (kind < 0 || kind > 3 || n < 0 || block <= 0 || block > 1024 ||
      (block % 32 != 0 && block != 1))
    return (int)cudaErrorInvalidValue;
  latency_kernel<<<1, block, 0, static_cast<cudaStream_t>(stream)>>>(kind, n,
                                                                    static_cast<int*>(sink));
  return (int)cudaGetLastError();
}

// n dependent device-memory loads on one thread, from buf[start]: buf
// (int32 indices into itself); sink (1,) int32.
int allwave_probe_dram(const void* buf, int start, int n, void* sink, void* stream) {
  dram_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(buf), (unsigned)start, n, static_cast<int*>(sink));
  return (int)cudaGetLastError();
}

}  // extern "C"
