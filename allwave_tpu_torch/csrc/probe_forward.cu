// Probe of the dense forward sweep with its bands in registers (x1):
// variants V1 (the activity range from d and the lengths every step),
// V2 (from thresholds computed once) and V3 (V2 without the plane).
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
// least 9 int32 instruction slots an active cell (+19 for the choice
// byte and run length), and the plane is 2 bytes a cell (3.2 GB at
// B = 4096, l_pad = 1024, K = 192: 0.96 ms of HBM, which bounds V1 and
// V2 there).
//
// Design: one warp runs one pair, four pairs a block, no block barrier.
// Each thread keeps LPT = K / 32 adjacent lanes of the five bands and
// of the run band in registers; the neighbours at k - 1 and k + 1 come
// by __shfl_up_sync / __shfl_down_sync. k0 is even, so a lane's parity
// of k is its register index's, and the step loop runs two steps a turn
// (odd d, then even d): the lanes that may move at a step are known at
// compile time, and only they are updated, in place (their neighbours
// are of the other parity and do not move). V1 and V2 compute every
// lane's plane entry, from the values before the step; V3 computes only
// the moving lanes and exchanges only the side they read.
//
// No division in any loop. (d -+ k - 2) mod 2 l_pad, halved, is
// floor((d -+ k - 2) / 2) mod l_pad, and d -+ k - 2 only runs over
// [-(K + 1), 2 l_pad + K]: each pair's bases are staged once in shared
// memory as two tables of l_pad + K / 2 bytes, extended by the wrap at
// both ends (filled with a running index, wrapped by a compare; ptxas
// may turn the first index's wrap into one remainder, before any loop), so
// that a thread reads its lanes' bases at offsets fixed at compile time
// from two pointers that move one byte a turn; adjacent lanes that share
// a base load it once. The clamp comes from a countdown of turns. The
// activity and diagonal tests are one [lo, hi] range of register
// indices a thread and step: V1 computes it from d and the lengths; V2
// from thresholds computed once, and between the two steps where every
// lane of the band has its diagonal term and no lane has left the
// matrix (a window computed once a pair) it runs a step with no test at
// all. A thread stores its entries 8 or 16 bytes at a time where LPT
// allows (at LPT = 6, one 8-byte and one 4-byte store).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int INF = 1 << 29;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // pairs a block

struct Pen {
  int x, o1e1, e1, o2e2, e2, o1, o2;
};

// floor(a / 2) of a compile-time constant
__host__ __device__ constexpr int fl2(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

// blocks of 128 threads an SM must hold: 4 (128 registers a thread),
// 3 at 8 lanes a thread (170)
__host__ __device__ constexpr int min_blocks(int lpt) { return lpt >= 8 ? 3 : 4; }

// a thread's LPT plane entries, words w[r / 2] (entry r in the low half
// when r is even), at pd (pd 4-byte aligned, 16-byte aligned at lane 0)
template <int LPT>
__device__ __forceinline__ void store_entries(uint16_t* pd, const uint32_t (&w)[LPT / 2],
                                              int lane) {
  if constexpr (LPT == 8) {
    *reinterpret_cast<uint4*>(pd) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (LPT == 4) {
    *reinterpret_cast<uint2*>(pd) = make_uint2(w[0], w[1]);
  } else if constexpr (LPT == 6) {
    // 12 bytes at 12 lane: an even lane's first 8 are 8-byte aligned, an
    // odd lane's last 8
    const bool odd = lane & 1;
    *reinterpret_cast<uint2*>(pd + (odd ? 2 : 0)) =
        make_uint2(odd ? w[1] : w[0], odd ? w[2] : w[1]);
    *reinterpret_cast<uint32_t*>(pd + (odd ? 0 : 4)) = odd ? w[0] : w[2];
  } else {
    static_assert(LPT == 2, "LPT in {2, 4, 6, 8}");
    *reinterpret_cast<uint32_t*>(pd) = w[0];
  }
}

// The per-pair state a step reads besides the bands.
struct Ctx {
  const uint8_t* qp;  // q table at this turn's base (odd step: qp[fl2(-1 - r)])
  const uint8_t* tp;  // t table at this turn's base (odd step: tp[fl2(r - 1)])
  uint16_t* pd;       // plane row of the next step, this thread's lanes
  size_t pstride;
  int lane;
};

// One step of parity ODD (d odd: the odd registers may move). FAST: every
// lane of the band has its diagonal term and no moving lane has left the
// matrix (no test); else the moving lanes are those in [lo, hi] and the
// diagonal term exists in [dlo, dhi].
template <int LPT, bool PLANES, bool FAST, bool ODD>
__device__ __forceinline__ void step(int (&S)[LPT], int (&I1)[LPT], int (&D1)[LPT],
                                     int (&I2)[LPT], int (&D2)[LPT], int (&R)[LPT],
                                     Ctx& c, const Pen& pen, int lo, int hi, int dlo,
                                     int dhi) {
  constexpr int MP = ODD ? 1 : 0;  // the moving registers' parity
  const int lane = c.lane;
  // neighbours at k - 1 (S, I1, I2) and k + 1 (S, D1, D2), INF past the
  // band's ends; without a plane only the side the moving lanes read
  int sl = INF, i1l = INF, i2l = INF, sr = INF, d1r = INF, d2r = INF;
  if (PLANES || !ODD) {
    sl = __shfl_up_sync(FULL, S[LPT - 1], 1);
    i1l = __shfl_up_sync(FULL, I1[LPT - 1], 1);
    i2l = __shfl_up_sync(FULL, I2[LPT - 1], 1);
    if (lane == 0) sl = i1l = i2l = INF;
  }
  if (PLANES || ODD) {
    sr = __shfl_down_sync(FULL, S[0], 1);
    d1r = __shfl_down_sync(FULL, D1[0], 1);
    d2r = __shfl_down_sync(FULL, D2[0], 1);
    if (lane == 31) sr = d1r = d2r = INF;
  }
  int nS[LPT / 2], nI1[LPT / 2], nD1[LPT / 2], nI2[LPT / 2], nD2[LPT / 2], nR[LPT / 2];
  uint32_t w[LPT / 2];
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    const bool moving = (r & 1) == MP;
    if (!PLANES && !moving) continue;
    const int s_km1 = r > 0 ? S[r - 1] : sl;
    const int s_kp1 = r < LPT - 1 ? S[r + 1] : sr;
    const int i1e = (r > 0 ? I1[r - 1] : i1l) + pen.e1;
    const int i1o = s_km1 + pen.o1e1;
    const int d1e = (r < LPT - 1 ? D1[r + 1] : d1r) + pen.e1;
    const int d1o = s_kp1 + pen.o1e1;
    const int i2e = (r > 0 ? I2[r - 1] : i2l) + pen.e2;
    const int i2o = s_km1 + pen.o2e2;
    const int d2e = (r < LPT - 1 ? D2[r + 1] : d2r) + pen.e2;
    const int d2o = s_kp1 + pen.o2e2;
    const int i1n = min(i1o, i1e), d1n = min(d1o, d1e);
    const int i2n = min(i2o, i2e), d2n = min(d2o, d2e);
    const int bi = min(i1n, i2n), bd = min(d1n, d2n);
    const int best = min(bi, bd);
    // lane r reads q[floor((d - k - 2) / 2)] and t[floor((d + k - 2) / 2)]
    const bool match = c.qp[ODD ? fl2(-1 - r) : fl2(-r)] == c.tp[ODD ? fl2(r - 1) : fl2(r)];
    const bool diag_ok = FAST || (r >= dlo && r <= dhi);
    const int diag = diag_ok ? S[r] + (match ? 0 : pen.x) : INF;
    const int sn = min(diag, best);
    int newrun = 0;
    if (PLANES) {
      // diag-mismatch over any gap, a gap over a diagonal match; among
      // the gaps the first of I1, I2, D1, D2
      const int code = bi <= bd ? (i1n <= i2n ? 2 : 3) : (d1n <= d2n ? 4 : 5);
      const int choice = diag <= best && diag_ok && !match ? 1 : (best == sn ? code : 0);
      const int packed = choice | ((i1e <= i1o) << 3) | ((d1e <= d1o) << 4) |
                         ((i2e <= i2o) << 5) | ((d2e <= d2o) << 6);
      newrun = choice == 0 ? min(R[r], 254) + 1 : 0;
      const uint32_t entry = (uint32_t)(packed | (newrun << 8));
      if (r & 1)
        w[r / 2] |= entry << 16;
      else
        w[r / 2] = entry;
    }
    if (moving) {
      const bool active = FAST || (r >= lo && r <= hi);
      nS[r / 2] = active ? sn : S[r];
      nI1[r / 2] = active ? i1n : I1[r];
      nD1[r / 2] = active ? d1n : D1[r];
      nI2[r / 2] = active ? i2n : I2[r];
      nD2[r / 2] = active ? d2n : D2[r];
      if (PLANES) nR[r / 2] = active ? newrun : R[r];
    }
  }
  if (PLANES) {
    store_entries<LPT>(c.pd, w, lane);
    c.pd += c.pstride;
  }
#pragma unroll
  for (int r = MP; r < LPT; r += 2) {
    S[r] = nS[r / 2];
    I1[r] = nI1[r / 2];
    D1[r] = nD1[r / 2];
    I2[r] = nI2[r / 2];
    D2[r] = nD2[r / 2];
    if (PLANES) R[r] = nR[r / 2];
  }
}

template <int LPT, bool OPT, bool PLANES>
__global__ void __launch_bounds__(32 * WARPS, min_blocks(LPT)) probe_forward_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens, int B,
    int l_pad, int K, int d_chunk, Pen pen, int* __restrict__ scores,
    uint8_t* __restrict__ cert, uint16_t* __restrict__ planes) {
  static_assert(LPT % 2 == 0, "a lane's parity of k is its index's");
  extern __shared__ __align__(16) uint8_t sbase[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // a whole warp: no block barrier follows
  const int tbl = l_pad + K / 2;  // bytes of each table
  uint8_t* qt = sbase + (size_t)warp * 2 * tbl;
  uint8_t* tt = qt + tbl;

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
  const int kb = k0 + c0;  // even: register r holds k = kb + r
  const int D2n = 2 * l_pad;

  // the tables: qt[i] = q[(hq0 + i) mod l_pad] for every floor((d - k -
  // 2) / 2), tt[i] = t[(ht0 + i) mod l_pad] for every floor((d + k - 2)
  // / 2), 1 <= d <= 2 l_pad, k0 <= k < k0 + K
  const int hq0 = -((k0 + K) >> 1), ht0 = (k0 >> 1) - 1;
  {
    const uint8_t* q = qs + (size_t)b * l_pad;
    const uint8_t* t = ts + (size_t)b * l_pad;
    int vq = hq0 + lane, vt = ht0 + lane;
    while (vq < 0) vq += l_pad;
    while (vq >= l_pad) vq -= l_pad;
    while (vt < 0) vt += l_pad;
    while (vt >= l_pad) vt -= l_pad;
    for (int i = lane; i < tbl; i += 32) {  // l_pad >= 64: one wrap a turn
      qt[i] = q[vq];
      tt[i] = t[vt];
      vq += 32;
      vt += 32;
      vq -= vq >= l_pad ? l_pad : 0;
      vt -= vt >= l_pad ? l_pad : 0;
    }
  }
  __syncwarp();

  int S[LPT], I1[LPT], D1[LPT], I2[LPT], D2[LPT], R[LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    S[r] = kb + r == 0 ? 0 : INF;
    I1[r] = D1[r] = I2[r] = D2[r] = INF;
    R[r] = 0;
  }
  // turn m runs d = 2m + 1 and 2m + 2; at turn 0 the odd step reads
  // qt[(-kb / 2 - hq0) + fl2(-1 - r)] and tt[(kb / 2 - ht0) + fl2(r - 1)]
  Ctx c;
  c.qp = qt + (-(kb >> 1) - hq0);
  c.tp = tt + ((kb >> 1) - ht0);
  c.pstride = (size_t)B * K;
  c.pd = PLANES ? planes + (size_t)b * K + c0 : nullptr;
  c.lane = lane;
  const int half_chunk = d_chunk >> 1;  // d_chunk is even: the clamp's d is
  int countdown = half_chunk;

  // V2's thresholds, once: a thread's lane r moves at d iff lo <= r <=
  // hi with lo = max(ea - d, d - eb), hi = min(d - ec, ed - d); its
  // diagonal term iff 2 + ea - d <= r <= d - ec - 2. Every lane of the
  // band has both between the steps f_lo and f_hi.
  const int ea = -kb, eb = kb + q2, ec = kb, ed = t2 - kb;
  const int f_lo = max(-k0, k0 + K - 1) + 2;
  const int f_hi = min(k0 + q2, t2 - (k0 + K - 1));

  auto turn = [&](int m, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = 2 * m + 1 + half;
      int lo = 0, hi = LPT - 1, dlo = 0, dhi = LPT - 1;
      if (!FAST) {
        if (OPT) {
          lo = max(ea - d, d - eb);
          hi = min(d - ec, ed - d);
          dlo = 2 + ea - d;
          dhi = d - ec - 2;
        } else {
          const int x = d - kb, y = d + kb;
          lo = max(-y, x - q2);
          hi = min(x, t2 - y);
          dlo = 2 - y;
          dhi = x - 2;
        }
      }
      if (half == 0)
        step<LPT, PLANES, FAST, true>(S, I1, D1, I2, D2, R, c, pen, lo, hi, dlo, dhi);
      else
        step<LPT, PLANES, FAST, false>(S, I1, D1, I2, D2, R, c, pen, lo, hi, dlo, dhi);
    }
    ++c.qp;
    ++c.tp;
    if (--countdown == 0) {  // d = 2m + 2 is a multiple of d_chunk
      countdown = half_chunk;
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        S[r] = min(S[r], INF);
        I1[r] = min(I1[r], INF);
        D1[r] = min(D1[r], INF);
        I2[r] = min(I2[r], INF);
        D2[r] = min(D2[r], INF);
      }
    }
  };
  using Slow = std::false_type;
  using Fast = std::true_type;
  int m = 0;
  if (OPT) {
    // the turns whose two steps lie in [f_lo, f_hi]: m in [m_lo, m_hi)
    const int m_lo = min(max(f_lo >> 1, 0), l_pad);
    const int m_hi = min(max(f_hi >> 1, m_lo), l_pad);
    for (; m < m_lo; ++m) turn(m, Slow{});
    for (; m < m_hi; ++m) turn(m, Fast{});
  }
  for (; m < l_pad; ++m) turn(m, Slow{});

  const int c_end = min(max(k_end - k0, 0), K - 1);
  if (c_end >= c0 && c_end < c0 + LPT) {
    int s = INF;
#pragma unroll
    for (int r = 0; r < LPT; ++r)
      if (c0 + r == c_end) s = S[r];
    const bool feasible = abs_kend <= K - 1 && qlen + tlen <= D2n;
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
  const int smem = WARPS * 2 * (l_pad + K / 2);
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
// variant 1-3 (V1-V3); K = 32 * LPT with LPT in {2, 4, 6, 8}; l_pad >=
// 64 and d_chunk even (kexp.check_shape).
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
  if (B <= 0 || l_pad < 64 || d_chunk <= 0 || (d_chunk & 1) ||
      (variant != 3) != (planes != nullptr))
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
