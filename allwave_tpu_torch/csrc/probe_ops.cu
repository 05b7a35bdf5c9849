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
// on 8192 or 16384 elements: operations, at 1/132 of the card for one
// copy. `copies` blocks each run the chain on their own copy to fill
// the card. A roll does no arithmetic, but its shuffles share the
// issue slots and an SM's shuffle unit gives half the results a clock
// that its INT32 lanes do: the fewer shuffles an element, the nearer
// the chain comes to its adds alone.
//
// Design: each thread holds E adjacent elements of a line (a segment;
// E = seg_elems below: 32 where ROLLS x UNROLL is a multiple of 32, else
// 8), so a line of 128 spans 128 / E threads of one warp and a thread
// holds 8192 / 256 / E or 16384 / 256 / E segments of different lines,
// whatever the axis (the loads and stores index the tile by axis). A
// roll is one __shfl_sync a segment, the element the thread before in
// the line held last; the thread's other elements are renamed, which
// costs nothing where the rotation comes back to the identity at the
// step loop's back edge (ROLLS x UNROLL a multiple of E) and register
// moves where it does not (x2's 4r case: a rotation by 4 of 8). Every
// roll still moves data: no two are merged and none is folded into the
// stores. The adds, selects and mins are volatile inline PTX with
// operands in registers, so the compiler drops none of them (ptxas
// still merges two adds into one three-input IADD3); they run op by op
// across all of a thread's elements, which are independent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LINE = 128;
constexpr int THREADS = 256;

// elements of a line a thread holds: the widest of 32 and 8 whose
// renaming comes back to the identity after one turn of the step loop
// (ROLLS x UNROLL rolls), else 8
__host__ __device__ constexpr int seg_elems(int rolls, int unroll) {
  return rolls * unroll > 0 && (rolls * unroll) % 32 == 0 ? 32 : 8;
}

// one block an SM (a copy): up to 255 registers a thread, so that the
// 64 elements of a 128-line tile and the op constants fit without a spill
template <int LINES, int ROLLS, int ADDS, int SELS, int MINS, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1) ops_kernel(const int* __restrict__ x,
                                                      int* __restrict__ out,
                                                      int axis, int C,
                                                      int n_iter, int zero) {
  constexpr int E = seg_elems(ROLLS, UNROLL);
  constexpr int TPL = LINE / E;                      // threads a line
  constexpr int NSEG = LINES * LINE / THREADS / E;   // segments a thread
  constexpr int LSTEP = THREADS / TPL;               // lines between them
  static_assert(NSEG >= 1 && 32 % TPL == 0, "a line lies inside one warp");
  const int lane = threadIdx.x & 31;
  const int m0 = threadIdx.x / TPL, e0 = (threadIdx.x % TPL) * E;
  // the thread before in the line, cyclic: it holds elements e0 - E ..
  const int src = (lane & ~(TPL - 1)) | ((lane + TPL - 1) & (TPL - 1));
  int ca[ADDS > 0 ? ADDS : 1], cs[SELS > 0 ? SELS : 1], cm[MINS > 0 ? MINS : 1];
#pragma unroll
  for (int i = 0; i < ADDS; ++i) ca[i] = zero + i + 1;
#pragma unroll
  for (int i = 0; i < SELS; ++i) cs[i] = zero + i;
#pragma unroll
  for (int i = 0; i < MINS; ++i) cm[i] = zero + (1 << 29) - i;

  int v[NSEG][E];
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int m = m0 + s * LSTEP, e = e0 + r;
      v[s][r] = x[axis == 1 ? m * C + e : e * C + m];
    }

  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < ROLLS; ++k)
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          const int t = __shfl_sync(FULL, v[s][E - 1], src);
#pragma unroll
          for (int r = E - 1; r > 0; --r) v[s][r] = v[s][r - 1];
          v[s][0] = t;
        }
#pragma unroll
      for (int i = 0; i < ADDS; ++i)
#pragma unroll
        for (int s = 0; s < NSEG; ++s)
#pragma unroll
          for (int r = 0; r < E; ++r)
            asm volatile("add.s32 %0, %0, %1;" : "+r"(v[s][r]) : "r"(ca[i]));
#pragma unroll
      for (int i = 0; i < SELS; ++i)
#pragma unroll
        for (int s = 0; s < NSEG; ++s)
#pragma unroll
          for (int r = 0; r < E; ++r)
            asm volatile(
                "{ .reg .pred p; setp.gt.s32 p, %0, 0; selp.s32 %0, %0, %1, p; }"
                : "+r"(v[s][r]) : "r"(cs[i]));
#pragma unroll
      for (int i = 0; i < MINS; ++i)
#pragma unroll
        for (int s = 0; s < NSEG; ++s)
#pragma unroll
          for (int r = 0; r < E; ++r)
            asm volatile("min.s32 %0, %0, %1;" : "+r"(v[s][r]) : "r"(cm[i]));
    }
  }

  int* o = out + (size_t)blockIdx.x * LINES * LINE;
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int m = m0 + s * LSTEP, e = e0 + r;
      o[axis == 1 ? m * C + e : e * C + m] = v[s][r];
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
    ops_kernel<LN, R, A, S, M, U><<<copies, THREADS, 0, st>>>(             \
        static_cast<const int*>(x), static_cast<int*>(out), axis, C,       \
        n_iter, 0);                                                        \
    return (int)cudaGetLastError();                                        \
  }
  AW_CASES(AW_DISPATCH)
#undef AW_DISPATCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
