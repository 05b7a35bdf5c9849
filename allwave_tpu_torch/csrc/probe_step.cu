// Probes of the dense engines' anti-diagonal step: the score-only step
// (x4), the step split into one launch a chunk (x5), and the step with
// choices storing its plane in four formats (x6).
//
// Replaces: scripts/experiments/kexp6.py `run` -> pallas_call (kernels
// `kernel_v0`, `make_v_carry`, `kernel_v4`, step `step_math`),
// kexp7.py `make_kernel` (pallas_call in `run`) and kexp8.py
// `make_kernel` (pallas_call in `run`). Plain twins:
// allwave_tpu_torch/probes/kexp6.py, kexp7.py, kexp8.py.
//
// The function: TB independent problems of K diagonals run the 5-band
// two-piece Gotoh step with the experiments' fixed penalties at
// anti-diagonals d = base + step + 2; two int32 stream registers of
// W + K lanes rotate by one lane a step (query right, target left) and
// the band reads lanes W.. of the first and ..K of the second. Band
// neighbours beyond lane 0 and lane K-1 are INF. Adds wrap (unsigned),
// as the JAX code's do.
//
// What bounds it on an H100: every step depends on the one before, and
// a problem is one block, so at the experiments' TB = 8 or 16 problems
// only 8 or 16 of the 132 SMs work and a step costs one block's ~40
// int32 instructions a lane plus its barrier: operations, far below the
// card's rate. The plane stores of x6 (2 to 4 bytes a lane and step,
// 0.27-0.54 GB at TB = 16, K = 2048, 4096 steps) are 0.08-0.16 ms of
// HBM; what they cost is their latency on 16 blocks.
//
// Design: two kernels.
// * step_smem_kernel (x4 v0, every x5 and x6 variant): one block a
//   problem, lanes strided over up to 1024 threads, the five bands (and
//   x6's run band) double-buffered in shared memory so that a step needs
//   one __syncthreads. The stream registers sit in shared memory twice
//   over, so that a lane reads its stream value at (offset + c) with the
//   offset moved by one a step instead of rotating W + K lanes. A launch
//   runs steps n0 .. n0 + n_steps - 1 and loads/stores the state from/to
//   a device buffer, which is how x5 runs one launch a chunk.
// * step_regs_kernel (x4 v1-v4): 256 threads a block, each keeping
//   LPT = K / 256 adjacent lanes of every band in registers. Neighbours
//   inside a warp come by __shfl_up_sync / __shfl_down_sync; at warp
//   edges from a double-buffered halo in shared memory (one barrier a
//   step). The step loop is unrolled UNROLL times; COPIES = 2 runs two
//   problems (s_in and s_in + 1) interleaved and outputs the sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = (1 << 30) - 1;
constexpr int O1E1 = 10, E1 = 2, O2E2 = 25, E2 = 1, XP = 5;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct Terms {
  int i1n, d1n, i2n, d2n, sn, diag;
  bool i1x, d1x, i2x, d2x, match, active;
};

// kexp6.py step_math at lane c, anti-diagonal d: own S; the left
// neighbour's S, I1, I2 and the right one's S, D1, D2 (INF at the
// band's edges); the two stream values
__device__ __forceinline__ Terms step_terms(int s, int sl, int i1l, int i2l,
                                            int sr, int d1r, int d2r, int qv,
                                            int tv, int c, int d, int q2) {
  Terms t;
  const int lo = max(d - q2, -d), hi = min(q2 - d, d);
  t.active = ((c & 1) == (d & 1)) && c >= lo && c <= hi;
  const int i1e = wadd(i1l, E1), i1o = wadd(sl, O1E1);
  const int d1e = wadd(d1r, E1), d1o = wadd(sr, O1E1);
  const int i2e = wadd(i2l, E2), i2o = wadd(sl, O2E2);
  const int d2e = wadd(d2r, E2), d2o = wadd(sr, O2E2);
  t.i1n = min(i1o, i1e);
  t.d1n = min(d1o, d1e);
  t.i2n = min(i2o, i2e);
  t.d2n = min(d2o, d2e);
  t.i1x = i1e <= i1o;
  t.d1x = d1e <= d1o;
  t.i2x = i2e <= i2o;
  t.d2x = d2e <= d2o;
  const int best = min(min(t.i1n, t.d1n), min(t.i2n, t.d2n));
  t.match = qv == tv;
  t.diag = (c <= d - 2 && c >= 2 - d) ? wadd(s, t.match ? 0 : XP) : INF;
  t.sn = min(t.diag, best);
  return t;
}

// ---------------------------------------------------------------------
// shared-memory bands (x4 v0, x5, x6)

template <int PLANE>  // 0 none; 1 two u8 planes; 2 one u16; 3 one i32
__global__ void step_smem_kernel(
    const int* __restrict__ qb0, const int* __restrict__ tb0,
    const int* __restrict__ s_in, int TB, int K, int W, int fill, int q2,
    int n0, int n_steps, int chunk, int* state, const int* base_ptr,
    int* sout, int sout_every, int sout_last, uint8_t* dummy, void* plane0,
    void* plane1) {
  extern __shared__ int sm[];
  const int L = W + K;
  int* band = sm;                                // [2][5][K]
  int* runb = band + 10 * K;                     // [2][K] when PLANE
  int* qrow = runb + (PLANE ? 2 * K : 0);        // [2L]
  int* trow = qrow + 2 * L;                      // [2L]
#define BAND(buf, i) (band + ((buf) * 5 + (i)) * K)
  const size_t row = (size_t)blockIdx.x * K;
  const size_t bstride = (size_t)TB * K;

  for (int x = threadIdx.x; x < L; x += blockDim.x) {
    const int qv = x < W ? fill : qb0[row + x - W];
    const int tv = x < K ? tb0[row + x] : fill;
    qrow[x] = qv;
    qrow[x + L] = qv;
    trow[x] = tv;
    trow[x + L] = tv;
  }
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    if (n0 == 0) {
      BAND(0, 0)[c] = s_in[row + c];
      for (int i = 1; i < 5; ++i) BAND(0, i)[c] = INF;
    } else {
      for (int i = 0; i < 5; ++i) BAND(0, i)[c] = state[i * bstride + row + c];
    }
    if (PLANE) runb[c] = 0;  // a plane sweep is one launch from step 0
  }
  const int base = base_ptr != nullptr ? *base_ptr : 0;
  __syncthreads();

  // stream offsets at step n0, after its n0 + 1 rotations
  int pq = (W - (n0 + 1)) % L;
  if (pq < 0) pq += L;
  int pt = (n0 + 1) % L;
  for (int i = 0; i < n_steps; ++i) {
    const int g = n0 + i;
    const int d = base + g + 2;
    const int pb = i & 1, nb = pb ^ 1;
    const int* S = BAND(pb, 0);
    const int* I1 = BAND(pb, 1);
    const int* D1 = BAND(pb, 2);
    const int* I2 = BAND(pb, 3);
    const int* D2 = BAND(pb, 4);
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const bool left = c > 0, right = c < K - 1;
      const int s = S[c];
      const Terms t = step_terms(
          s, left ? S[c - 1] : INF, left ? I1[c - 1] : INF,
          left ? I2[c - 1] : INF, right ? S[c + 1] : INF,
          right ? D1[c + 1] : INF, right ? D2[c + 1] : INF, qrow[pq + c],
          trow[pt + c], c, d, q2);
      if (PLANE) {
        // kexp8.py's codes, last write wins
        int choice = 0;
        if (t.d2n == t.sn) choice = 5;
        if (t.d1n == t.sn) choice = 3;
        if (t.i2n == t.sn) choice = 4;
        if (t.i1n == t.sn) choice = 2;
        if (t.diag == t.sn && !t.match) choice = 1;
        const int packed = choice | (t.i1x << 3) | (t.d1x << 4) |
                           (t.i2x << 5) | (t.d2x << 6);
        const int runp = runb[pb * K + c];
        const int newrun = choice == 0 ? min(runp, 254) + 1 : 0;
        const size_t at = (size_t)g * bstride + row + c;
        if (PLANE == 1) {
          static_cast<uint8_t*>(plane0)[at] = (uint8_t)packed;
          static_cast<uint8_t*>(plane1)[at] = (uint8_t)newrun;
        } else if (PLANE == 2) {
          static_cast<uint16_t*>(plane0)[at] = (uint16_t)(packed | (newrun << 8));
        } else {
          static_cast<int*>(plane0)[at] = packed | (newrun << 8);
        }
        runb[nb * K + c] = t.active ? newrun : runp;
      }
      BAND(nb, 0)[c] = t.active ? t.sn : s;
      BAND(nb, 1)[c] = t.active ? t.i1n : I1[c];
      BAND(nb, 2)[c] = t.active ? t.d1n : D1[c];
      BAND(nb, 3)[c] = t.active ? t.i2n : I2[c];
      BAND(nb, 4)[c] = t.active ? t.d2n : D2[c];
    }
    __syncthreads();
    pq = pq == 0 ? L - 1 : pq - 1;
    pt = pt == L - 1 ? 0 : pt + 1;
    if ((i + 1) % chunk == 0 && (sout_every || dummy != nullptr)) {
      // the next step writes the other buffer: no barrier needed
      const int* Sx = BAND(nb, 0);
      for (int c = threadIdx.x; c < K; c += blockDim.x) {
        if (sout_every) sout[row + c] = Sx[c];
        if (dummy != nullptr) dummy[row + c] = (uint8_t)Sx[c];
      }
    }
  }
  const int fb = n_steps & 1;
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    if (state != nullptr)
      for (int i = 0; i < 5; ++i) state[i * bstride + row + c] = BAND(fb, i)[c];
    if (sout_last) sout[row + c] = BAND(fb, 0)[c];
  }
#undef BAND
}

// ---------------------------------------------------------------------
// register bands (x4 v1-v4)

constexpr int REG_THREADS = 256;
constexpr int REG_WARPS = REG_THREADS / 32;

template <int LPT, int UNROLL, int COPIES>
__global__ void __launch_bounds__(REG_THREADS) step_regs_kernel(
    const int* __restrict__ qb0, const int* __restrict__ tb0,
    const int* __restrict__ s_in, int K, int W, int fill, int q2,
    int n_steps, int* __restrict__ sout) {
  extern __shared__ int sm[];
  const int L = W + K;
  int* qrow = sm;          // [2L]
  int* trow = sm + 2 * L;  // [2L]
  // [2 buffers][COPIES][warps][6]: a warp's last lane (S, I1, I2) and
  // its first lane (S, D1, D2)
  int* halo = trow + 2 * L;
#define HALO(buf, cp, w) (halo + (((buf) * COPIES + (cp)) * REG_WARPS + (w)) * 6)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)blockIdx.x * K;
  const int c0 = tid * LPT;

  for (int x = tid; x < L; x += REG_THREADS) {
    const int qv = x < W ? fill : qb0[row + x - W];
    const int tv = x < K ? tb0[row + x] : fill;
    qrow[x] = qv;
    qrow[x + L] = qv;
    trow[x] = tv;
    trow[x + L] = tv;
  }
  int S[COPIES][LPT], I1[COPIES][LPT], D1[COPIES][LPT], I2[COPIES][LPT],
      D2[COPIES][LPT];
#pragma unroll
  for (int cp = 0; cp < COPIES; ++cp)
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      S[cp][r] = wadd(s_in[row + c0 + r], cp);
      I1[cp][r] = D1[cp][r] = I2[cp][r] = D2[cp][r] = INF;
    }
#pragma unroll
  for (int cp = 0; cp < COPIES; ++cp) {
    if (lane == 31) {
      int* h = HALO(0, cp, warp);
      h[0] = S[cp][LPT - 1];
      h[1] = I1[cp][LPT - 1];
      h[2] = I2[cp][LPT - 1];
    }
    if (lane == 0) {
      int* h = HALO(0, cp, warp);
      h[3] = S[cp][0];
      h[4] = D1[cp][0];
      h[5] = D2[cp][0];
    }
  }
  __syncthreads();

  int pq = (W - 1) % L, pt = 1 % L;  // after the first step's rotation
  for (int g = 0; g < n_steps; g += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int step = g + u;
      const int d = step + 2;
      const int rb = step & 1, wb = rb ^ 1;
      int qv[LPT], tv[LPT];
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        qv[r] = qrow[pq + c0 + r];
        tv[r] = trow[pt + c0 + r];
      }
#pragma unroll
      for (int cp = 0; cp < COPIES; ++cp) {
        int sl = __shfl_up_sync(FULL, S[cp][LPT - 1], 1);
        int i1l = __shfl_up_sync(FULL, I1[cp][LPT - 1], 1);
        int i2l = __shfl_up_sync(FULL, I2[cp][LPT - 1], 1);
        int sr = __shfl_down_sync(FULL, S[cp][0], 1);
        int d1r = __shfl_down_sync(FULL, D1[cp][0], 1);
        int d2r = __shfl_down_sync(FULL, D2[cp][0], 1);
        if (lane == 0) {
          if (warp == 0) {
            sl = i1l = i2l = INF;
          } else {
            const int* h = HALO(rb, cp, warp - 1);
            sl = h[0];
            i1l = h[1];
            i2l = h[2];
          }
        }
        if (lane == 31) {
          if (warp == REG_WARPS - 1) {
            sr = d1r = d2r = INF;
          } else {
            const int* h = HALO(rb, cp, warp + 1);
            sr = h[3];
            d1r = h[4];
            d2r = h[5];
          }
        }
        int nS[LPT], nI1[LPT], nD1[LPT], nI2[LPT], nD2[LPT];
#pragma unroll
        for (int r = 0; r < LPT; ++r) {
          const Terms t = step_terms(
              S[cp][r], r > 0 ? S[cp][r - 1] : sl, r > 0 ? I1[cp][r - 1] : i1l,
              r > 0 ? I2[cp][r - 1] : i2l, r < LPT - 1 ? S[cp][r + 1] : sr,
              r < LPT - 1 ? D1[cp][r + 1] : d1r,
              r < LPT - 1 ? D2[cp][r + 1] : d2r, qv[r], tv[r], c0 + r, d, q2);
          nS[r] = t.active ? t.sn : S[cp][r];
          nI1[r] = t.active ? t.i1n : I1[cp][r];
          nD1[r] = t.active ? t.d1n : D1[cp][r];
          nI2[r] = t.active ? t.i2n : I2[cp][r];
          nD2[r] = t.active ? t.d2n : D2[cp][r];
        }
#pragma unroll
        for (int r = 0; r < LPT; ++r) {
          S[cp][r] = nS[r];
          I1[cp][r] = nI1[r];
          D1[cp][r] = nD1[r];
          I2[cp][r] = nI2[r];
          D2[cp][r] = nD2[r];
        }
        if (lane == 31) {
          int* h = HALO(wb, cp, warp);
          h[0] = S[cp][LPT - 1];
          h[1] = I1[cp][LPT - 1];
          h[2] = I2[cp][LPT - 1];
        }
        if (lane == 0) {
          int* h = HALO(wb, cp, warp);
          h[3] = S[cp][0];
          h[4] = D1[cp][0];
          h[5] = D2[cp][0];
        }
      }
      __syncthreads();
      pq = pq == 0 ? L - 1 : pq - 1;
      pt = pt == L - 1 ? 0 : pt + 1;
    }
  }
#pragma unroll
  for (int r = 0; r < LPT; ++r)
    sout[row + c0 + r] = COPIES == 2 ? wadd(S[0][r], S[COPIES - 1][r]) : S[0][r];
#undef HALO
}

template <int PLANE>
int launch_smem(const void* qb0, const void* tb0, const void* s_in, int TB,
                int K, int W, int fill, int q2, int n0, int n_steps, int chunk,
                void* state, const void* base, void* sout, int sout_every,
                int sout_last, void* dummy, void* plane0, void* plane1,
                cudaStream_t st) {
  const int threads = K >= 1024 ? 1024 : ((K + 31) / 32) * 32;
  const int smem = 4 * (10 * K + (PLANE ? 2 * K : 0) + 4 * (W + K));
  cudaFuncSetAttribute(step_smem_kernel<PLANE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  step_smem_kernel<PLANE><<<TB, threads, smem, st>>>(
      static_cast<const int*>(qb0), static_cast<const int*>(tb0),
      static_cast<const int*>(s_in), TB, K, W, fill, q2, n0, n_steps, chunk,
      static_cast<int*>(state), static_cast<const int*>(base),
      static_cast<int*>(sout), sout_every, sout_last,
      static_cast<uint8_t*>(dummy), plane0, plane1);
  return (int)cudaGetLastError();
}

template <int LPT, int UNROLL, int COPIES>
int launch_regs(const void* qb0, const void* tb0, const void* s_in, int TB,
                int K, int W, int fill, int q2, int n_steps, void* sout,
                cudaStream_t st) {
  const int smem = 4 * (4 * (W + K) + 2 * COPIES * REG_WARPS * 6);
  cudaFuncSetAttribute(step_regs_kernel<LPT, UNROLL, COPIES>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  step_regs_kernel<LPT, UNROLL, COPIES><<<TB, REG_THREADS, smem, st>>>(
      static_cast<const int*>(qb0), static_cast<const int*>(tb0),
      static_cast<const int*>(s_in), K, W, fill, q2, n_steps,
      static_cast<int*>(sout));
  return (int)cudaGetLastError();
}

template <int LPT>
int launch_regs_variant(int unroll, int copies, const void* qb0,
                        const void* tb0, const void* s_in, int TB, int K,
                        int W, int fill, int q2, int n_steps, void* sout,
                        cudaStream_t st) {
  if (copies == 2 && unroll == 2)
    return launch_regs<LPT, 2, 2>(qb0, tb0, s_in, TB, K, W, fill, q2, n_steps, sout, st);
  if (copies != 1) return (int)cudaErrorInvalidValue;
  if (unroll == 2)
    return launch_regs<LPT, 2, 1>(qb0, tb0, s_in, TB, K, W, fill, q2, n_steps, sout, st);
  if (unroll == 4)
    return launch_regs<LPT, 4, 1>(qb0, tb0, s_in, TB, K, W, fill, q2, n_steps, sout, st);
  if (unroll == 8)
    return launch_regs<LPT, 8, 1>(qb0, tb0, s_in, TB, K, W, fill, q2, n_steps, sout, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qb0, tb0, s_in: (TB, K) int32. state: (5, TB, K) int32 or null; base:
// one int32 or null; sout (TB, K) int32; dummy (TB, K) uint8 or null;
// plane_mode 1: two (n, TB, K) uint8 planes, 2: one uint16, 3: one
// int32 (a plane sweep starts at step 0: n0 == 0).
int allwave_probe_step_smem(const void* qb0, const void* tb0,
                            const void* s_in, int TB, int K, int W, int fill,
                            int q2, int n0, int n_steps, int chunk,
                            void* state, const void* base, void* sout,
                            int sout_every, int sout_last, void* dummy,
                            int plane_mode, void* plane0, void* plane1,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (TB <= 0 || n_steps <= 0 || chunk <= 0 || (plane_mode != 0 && n0 != 0))
    return (int)cudaErrorInvalidValue;
#define AW_LAUNCH(P)                                                         \
  launch_smem<P>(qb0, tb0, s_in, TB, K, W, fill, q2, n0, n_steps, chunk,     \
                 state, base, sout, sout_every, sout_last, dummy, plane0,    \
                 plane1, st)
  switch (plane_mode) {
    case 0: return AW_LAUNCH(0);
    case 1: return AW_LAUNCH(1);
    case 2: return AW_LAUNCH(2);
    case 3: return AW_LAUNCH(3);
  }
#undef AW_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// x4 v1-v4: K = 256 * LPT with LPT in {1, 2, 4, 6, 8}
int allwave_probe_step_regs(const void* qb0, const void* tb0,
                            const void* s_in, int TB, int K, int W, int fill,
                            int q2, int n_steps, int unroll, int copies,
                            void* sout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (TB <= 0 || unroll <= 0 || n_steps % unroll) return (int)cudaErrorInvalidValue;
#define AW_LAUNCH(LPT)                                                      \
  launch_regs_variant<LPT>(unroll, copies, qb0, tb0, s_in, TB, K, W, fill, \
                           q2, n_steps, sout, st)
  switch (K) {
    case 256: return AW_LAUNCH(1);
    case 512: return AW_LAUNCH(2);
    case 1024: return AW_LAUNCH(4);
    case 1536: return AW_LAUNCH(6);
    case 2048: return AW_LAUNCH(8);
  }
#undef AW_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
