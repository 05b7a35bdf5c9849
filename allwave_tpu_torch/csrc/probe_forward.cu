// Probe of the dense forward sweep with its bands in registers (x1):
// variants V1 (activity test per step), V2 (per-lane enter/leave
// thresholds) and V3 (V2 without the plane store).
//
// Replaces: scripts/experiments/kexp.py `forward_v` (pallas_call at
// :248, kernel `_kernel_v1`). Plain twin:
// allwave_tpu_torch/probes/kexp.py `forward_ref`.
//
// The function: the banded two-piece Gotoh forward of dense_forward
// (band geometry of csrc/dense_forward.cu, choice codes and run-length
// high byte of its plane) as the experiment computes it: lane k reads
// the bases q[((d - k - 2) mod 2 l_pad) >> 1] and t[((d + k - 2) mod
// 2 l_pad) >> 1] (the TPU kernel's wrapping streams), and the five bands
// are clamped to INF after every d_chunk-th step instead of every step.
// Scores, certificates and every reachable plane byte equal the
// engine's.
//
// What bounds it on an H100: each pair is 2 l_pad dependent steps of at
// least 19 int32 ops an active cell (+20 for the choice byte and run
// length), and the plane is 2 bytes a cell (3.2 GB at B = 4096, l_pad =
// 1024, K = 192: 0.96 ms of HBM). The ops bound it: 1.29 ms at the
// card's int32 rate at that shape, if every SM's INT32 lanes stayed busy.
//
// Design: one warp runs one pair, four pairs a block. Each thread keeps
// LPT = K / 32 adjacent lanes of the five bands and of the run band in
// registers; the neighbours at k - 1 and k + 1 come by __shfl_up_sync /
// __shfl_down_sync, so no step needs a barrier (csrc/dense_forward.cu
// keeps the bands in shared memory double buffers, one __syncthreads a
// step). The pair's bases are staged once in shared memory. A thread
// stores its LPT plane entries as LPT/2 32-bit words. The step loop runs
// two steps a turn, odd d then even d, so that V2's per-parity enter
// thresholds are chosen at compile time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 29;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // pairs a block

struct Pen {
  int x, o1e1, e1, o2e2, e2, o1, o2;
};

template <int LPT, bool OPT, bool PLANES>
__global__ void __launch_bounds__(32 * WARPS) probe_forward_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens, int B,
    int l_pad, int K, int d_chunk, Pen pen, int* __restrict__ scores,
    uint8_t* __restrict__ cert, uint16_t* __restrict__ planes) {
  extern __shared__ uint8_t sbase[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // a whole warp: no block barrier follows
  uint8_t* q = sbase + (size_t)warp * 2 * l_pad;
  uint8_t* t = q + l_pad;
  for (int i = lane; i < l_pad; i += 32) {
    q[i] = qs[(size_t)b * l_pad + i];
    t[i] = ts[(size_t)b * l_pad + i];
  }
  __syncwarp();

  const int qlen = qlens[b], tlen = tlens[b];
  const int q2 = 2 * qlen, t2 = 2 * tlen;
  // band geometry (csrc/dense_forward.cu): even-aligned k0
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  const int slack = (K - 1 - abs_kend) >> 1;
  int k0 = min(0, k_end) - slack;
  k0 -= (k0 & 1);
  const int width = min(min(0, k_end) - k0, (k0 + (K - 1)) - max(0, k_end));
  const int c0 = lane * LPT;
  const int D2 = 2 * l_pad;

  int S[LPT], I1[LPT], D1[LPT], I2[LPT], Dd2[LPT], R[LPT];
  // V2: active at d iff d >= enter (k of d's parity) and d <= leave; the
  // diagonal term iff d >= |k| + 2
  int enter[LPT], leave[LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    const int k = k0 + c0 + r;
    S[r] = k == 0 ? 0 : INF;
    I1[r] = D1[r] = I2[r] = Dd2[r] = INF;
    R[r] = 0;
    enter[r] = k < 0 ? -k : k;
    leave[r] = min(k + q2, t2 - k);
  }
  uint16_t* prow = PLANES ? planes + (size_t)b * K + c0 : nullptr;
  const size_t pstride = (size_t)B * K;

  for (int d0 = 1; d0 <= D2; d0 += 2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + half;
      const bool odd = half == 0;
      const int sl = __shfl_up_sync(FULL, S[LPT - 1], 1);
      const int i1l = __shfl_up_sync(FULL, I1[LPT - 1], 1);
      const int i2l = __shfl_up_sync(FULL, I2[LPT - 1], 1);
      const int sr = __shfl_down_sync(FULL, S[0], 1);
      const int d1r = __shfl_down_sync(FULL, D1[0], 1);
      const int d2r = __shfl_down_sync(FULL, Dd2[0], 1);
      int nS[LPT], nI1[LPT], nD1[LPT], nI2[LPT], nD2[LPT], nR[LPT];
      uint32_t word = 0;
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        const int k = k0 + c0 + r;
        // neighbours at k - 1 (S, I1, I2) and k + 1 (S, D1, D2)
        const int s_km1 = r > 0 ? S[r - 1] : (lane > 0 ? sl : INF);
        const int i1_km1 = r > 0 ? I1[r - 1] : (lane > 0 ? i1l : INF);
        const int i2_km1 = r > 0 ? I2[r - 1] : (lane > 0 ? i2l : INF);
        const int s_kp1 = r < LPT - 1 ? S[r + 1] : (lane < 31 ? sr : INF);
        const int d1_kp1 = r < LPT - 1 ? D1[r + 1] : (lane < 31 ? d1r : INF);
        const int d2_kp1 = r < LPT - 1 ? Dd2[r + 1] : (lane < 31 ? d2r : INF);
        bool active, diag_ok;
        if (OPT) {
          const bool par = ((k & 1) != 0) == odd;
          active = par && d >= enter[r] && d <= leave[r];
          diag_ok = d >= enter[r] + 2;
        } else {
          const int lo = max(d - q2, -d), hi = min(t2 - d, d);
          active = (k & 1) == (d & 1) && k >= lo && k <= hi;
          diag_ok = k <= d - 2 && k >= 2 - d;
        }
        const int i1e = i1_km1 + pen.e1, i1o = s_km1 + pen.o1e1;
        const int d1e = d1_kp1 + pen.e1, d1o = s_kp1 + pen.o1e1;
        const int i2e = i2_km1 + pen.e2, i2o = s_km1 + pen.o2e2;
        const int d2e = d2_kp1 + pen.e2, d2o = s_kp1 + pen.o2e2;
        const int i1n = min(i1o, i1e), d1n = min(d1o, d1e);
        const int i2n = min(i2o, i2e), d2n = min(d2o, d2e);
        const int best = min(min(i1n, d1n), min(i2n, d2n));
        int mq = (d - k - 2) % D2;
        if (mq < 0) mq += D2;
        int mt = (d + k - 2) % D2;
        if (mt < 0) mt += D2;
        const bool match = q[mq >> 1] == t[mt >> 1];
        const int diag = diag_ok ? S[r] + (match ? 0 : pen.x) : INF;
        const int sn = min(diag, best);
        if (PLANES) {
          // last write wins: D2 < D1 < I2 < I1 < diag-mismatch
          int choice = 0;
          if (d2n == sn) choice = 5;
          if (d1n == sn) choice = 4;
          if (i2n == sn) choice = 3;
          if (i1n == sn) choice = 2;
          if (diag_ok && diag == sn && !match) choice = 1;
          const int packed = choice | ((i1e <= i1o) << 3) | ((d1e <= d1o) << 4) |
                             ((i2e <= i2o) << 5) | ((d2e <= d2o) << 6);
          const int newrun = choice == 0 ? min(R[r], 254) + 1 : 0;
          const uint32_t entry = (uint32_t)(packed | (newrun << 8)) & 0xffffu;
          word |= entry << (16 * (r & 1));
          if (r & 1) {
            reinterpret_cast<uint32_t*>(prow + (size_t)(d - 1) * pstride)[r >> 1] = word;
            word = 0;
          }
          nR[r] = active ? newrun : R[r];
        }
        nS[r] = active ? sn : S[r];
        nI1[r] = active ? i1n : I1[r];
        nD1[r] = active ? d1n : D1[r];
        nI2[r] = active ? i2n : I2[r];
        nD2[r] = active ? d2n : Dd2[r];
      }
      const bool clamp = d % d_chunk == 0;
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        S[r] = clamp ? min(nS[r], INF) : nS[r];
        I1[r] = clamp ? min(nI1[r], INF) : nI1[r];
        D1[r] = clamp ? min(nD1[r], INF) : nD1[r];
        I2[r] = clamp ? min(nI2[r], INF) : nI2[r];
        Dd2[r] = clamp ? min(nD2[r], INF) : nD2[r];
        if (PLANES) R[r] = nR[r];
      }
    }
  }

  const int c_end = min(max(k_end - k0, 0), K - 1);
  if (c_end >= c0 && c_end < c0 + LPT) {
    int s = INF;
#pragma unroll
    for (int r = 0; r < LPT; ++r)
      if (c0 + r == c_end) s = S[r];
    const bool feasible = abs_kend <= K - 1 && qlen + tlen <= D2;
    const int score = feasible ? min(s, INF) : INF;
    const int n = max(width, 0) + 1;
    const int esc = 2 * min(pen.o1 + n * pen.e1, pen.o2 + n * pen.e2);
    const bool full_cover = k0 <= -qlen && k0 + (K - 1) >= tlen;
    scores[b] = score;
    cert[b] = ((score < esc) || full_cover) && feasible && score < INF;
  }
}

template <int LPT>
int launch(int variant, const void* qs, const void* ts, const void* qlens,
           const void* tlens, int B, int l_pad, int K, int d_chunk, Pen pen,
           void* scores, void* cert, void* planes, cudaStream_t st) {
  const int smem = 2 * l_pad * WARPS;
  const int grid = (B + WARPS - 1) / WARPS;
#define AW_GO(OPT, PL)                                                        \
  {                                                                           \
    cudaFuncSetAttribute(probe_forward_kernel<LPT, OPT, PL>,                  \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  \
    probe_forward_kernel<LPT, OPT, PL><<<grid, 32 * WARPS, smem, st>>>(       \
        static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),     \
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), B,    \
        l_pad, K, d_chunk, pen, static_cast<int*>(scores),                    \
        static_cast<uint8_t*>(cert), static_cast<uint16_t*>(planes));         \
    return (int)cudaGetLastError();                                           \
  }
  if (variant == 1) AW_GO(false, true)
  if (variant == 2) AW_GO(true, true)
  if (variant == 3) AW_GO(true, false)
#undef AW_GO
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qs, ts: (B, l_pad) uint8; qlens, tlens: (B,) int32; scores (B,) int32;
// cert (B,) uint8; planes (2 l_pad, B, K) uint16, or null for V3.
// variant 1-3 (V1-V3); K = 32 * LPT with LPT in {2, 4, 6, 8}.
int allwave_probe_forward(const void* qs, const void* ts, const void* qlens,
                          const void* tlens, int B, int l_pad, int K,
                          int d_chunk, int x, int o1, int e1, int o2, int e2,
                          int variant, void* scores, void* cert, void* planes,
                          void* stream) {
  Pen pen;
  pen.x = x;
  pen.o1 = o1;
  pen.e1 = e1;
  pen.o2 = o2;
  pen.e2 = e2;
  pen.o1e1 = o1 + e1;
  pen.o2e2 = o2 + e2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d_chunk <= 0 || (variant != 3) != (planes != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (K) {
    case 64: return launch<2>(variant, qs, ts, qlens, tlens, B, l_pad, K, d_chunk, pen, scores, cert, planes, st);
    case 128: return launch<4>(variant, qs, ts, qlens, tlens, B, l_pad, K, d_chunk, pen, scores, cert, planes, st);
    case 192: return launch<6>(variant, qs, ts, qlens, tlens, B, l_pad, K, d_chunk, pen, scores, cert, planes, st);
    case 256: return launch<8>(variant, qs, ts, qlens, tlens, B, l_pad, K, d_chunk, pen, scores, cert, planes, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
