// Op-cost probe: one chain of rolls, adds, selects and mins applied
// n_steps times to one int32 tile (x2, x3).
//
// Replaces: scripts/experiments/kexp2.py `make` (pallas_call in its
// `run`) and kexp3.py `make` (the same). Plain twin:
// allwave_tpu_torch/probes/kexp2.py `chain_ref`.
//
// The function, per step: ROLLS rotations by one element along the
// roll axis (new[e] = old[e - 1], cyclic over the axis's 128 elements);
// then a = a + (i + 1) for i < ADDS; a = a > 0 ? a : i for i < SELS;
// a = min(a, 2^29 - i) for i < MINS. The TPU runs the tile through a
// sequential grid of TILES steps, carrying it in scratch, so the chain
// runs TILES * STEPS times; here one block runs all of them.
//
// What bounds it on an H100: one block keeps one SM's INT32 lanes busy
// with ADDS/2 + 2 SELS + MINS int32 instructions per element and step
// (and ROLLS/4 shuffles) on 8192 or 16384 elements: operations, at 1/132 of
// the card for one copy. `copies` blocks each run the chain on their own
// copy to fill the card.
//
// Design: the tile's lines along the roll axis (128 elements) are each
// held by one warp, 4 adjacent elements a thread; a warp holds LINES/8
// lines, so the 8 warps of a block hold the tile in registers, whatever
// the axis (the loads and stores index the tile by axis). A roll is one
// __shfl_sync from the lane before and three register moves. The adds,
// selects and mins are volatile inline PTX with operands in registers,
// so the compiler drops none of them (ptxas still merges two adds into
// one three-input IADD3); they run op by op across all of a
// thread's elements, which are independent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LINE = 128;

template <int LINES, int ROLLS, int ADDS, int SELS, int MINS, int UNROLL>
__global__ void __launch_bounds__(256) ops_kernel(const int* __restrict__ x,
                                                  int* __restrict__ out,
                                                  int axis, int C,
                                                  int n_iter, int zero) {
  constexpr int LPW = LINES / 8;  // lines a warp holds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ca[ADDS > 0 ? ADDS : 1], cs[SELS > 0 ? SELS : 1], cm[MINS > 0 ? MINS : 1];
#pragma unroll
  for (int i = 0; i < ADDS; ++i) ca[i] = zero + i + 1;
#pragma unroll
  for (int i = 0; i < SELS; ++i) cs[i] = zero + i;
#pragma unroll
  for (int i = 0; i < MINS; ++i) cm[i] = zero + (1 << 29) - i;

  int v[LPW][4];
#pragma unroll
  for (int l = 0; l < LPW; ++l)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = warp + 8 * l, e = lane * 4 + r;
      v[l][r] = x[axis == 1 ? m * C + e : e * C + m];
    }

  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < ROLLS; ++k)
#pragma unroll
        for (int l = 0; l < LPW; ++l) {
          const int t = __shfl_sync(FULL, v[l][3], (lane + 31) & 31);
          v[l][3] = v[l][2];
          v[l][2] = v[l][1];
          v[l][1] = v[l][0];
          v[l][0] = t;
        }
#pragma unroll
      for (int i = 0; i < ADDS; ++i)
#pragma unroll
        for (int l = 0; l < LPW; ++l)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            asm volatile("add.s32 %0, %0, %1;" : "+r"(v[l][r]) : "r"(ca[i]));
#pragma unroll
      for (int i = 0; i < SELS; ++i)
#pragma unroll
        for (int l = 0; l < LPW; ++l)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            asm volatile(
                "{ .reg .pred p; setp.gt.s32 p, %0, 0; selp.s32 %0, %0, %1, p; }"
                : "+r"(v[l][r]) : "r"(cs[i]));
#pragma unroll
      for (int i = 0; i < MINS; ++i)
#pragma unroll
        for (int l = 0; l < LPW; ++l)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            asm volatile("min.s32 %0, %0, %1;" : "+r"(v[l][r]) : "r"(cm[i]));
    }
  }

  int* o = out + (size_t)blockIdx.x * LINES * LINE;
#pragma unroll
  for (int l = 0; l < LPW; ++l)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = warp + 8 * l, e = lane * 4 + r;
      o[axis == 1 ? m * C + e : e * C + m] = v[l][r];
    }
}

// (lines, rolls, adds, selects, mins, unroll): kexp2.py's nine cases,
// then kexp3.py's (allwave_tpu_torch/probes/kexp2.py and kexp3.py CASES)
#define AW_CASES(X)                                                        \
  X(64, 0, 8, 0, 0, 1) X(64, 0, 16, 0, 0, 1) X(64, 0, 32, 0, 0, 1)         \
  X(64, 8, 0, 0, 0, 1) X(64, 4, 0, 0, 0, 1) X(64, 8, 8, 8, 8, 1)           \
  X(64, 0, 8, 8, 8, 1) X(64, 0, 0, 16, 0, 1) X(64, 0, 0, 0, 16, 1)         \
  X(64, 8, 8, 0, 0, 1) X(128, 8, 8, 0, 0, 1) X(64, 8, 8, 0, 0, 4)          \
  X(128, 8, 8, 0, 0, 4) X(128, 8, 8, 0, 0, 8) X(64, 0, 8, 0, 0, 4)         \
  X(64, 0, 8, 0, 0, 8) X(128, 0, 8, 0, 0, 1)

}  // namespace

extern "C" {

// x: the (R, C) int32 tile, its roll axis 128 long and the other axis
// `lines` long; out: (copies, R, C) int32; the chain runs n_iter * unroll
// times. Returns cudaErrorInvalidValue for a chain with no instance.
int allwave_probe_ops(const void* x, void* out, int copies, int lines,
                      int rolls, int adds, int sels, int mins, int unroll,
                      int axis, int C, int n_iter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (copies <= 0 || n_iter < 0) return (int)cudaErrorInvalidValue;
#define AW_DISPATCH(LN, R, A, S, M, U)                                     \
  if (lines == LN && rolls == R && adds == A && sels == S && mins == M &&  \
      unroll == U) {                                                       \
    ops_kernel<LN, R, A, S, M, U><<<copies, 256, 0, st>>>(                 \
        static_cast<const int*>(x), static_cast<int*>(out), axis, C,       \
        n_iter, 0);                                                        \
    return (int)cudaGetLastError();                                        \
  }
  AW_CASES(AW_DISPATCH)
#undef AW_DISPATCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
