// Banded Gotoh forward sweep over anti-diagonals, with the merged
// choice/run-length traceback plane.
//
// Replaces: allwave_tpu/wfa/pallas_dense.py `_forward_t` (kernel
// `_kernel_t` / `run_dp_chunk_t`, K <= 2048) and `_forward_c2` (kernel
// `_kernel_c2` / `run_dp_chunk_c2`, the escalation bands 2048 < K <=
// 16384). Both compute the function of allwave_tpu/wfa/dense.py
// `dense_forward`; they differ only in TPU layout, so one source serves
// every K here. Its plain twin is allwave_tpu_torch/wfa/dense.py
// `dense_forward_ref`: scores, certificates and every plane entry --
// reachable or not -- equal its.
//
// What bounds it on an H100: each pair is a chain of 2*l_pad dependent
// steps, each a few dozen integer min/add/compare ops per band lane
// (the plane entry included) and one 2-byte plane store per lane. At
// B = 4096, l_pad = 1024, K = 192 the plane is 3.2 GB (0.96 ms of HBM)
// and the least int32 issue slots ~1.1 ms: the kernel is bound by
// issue, and by the latency of each step when few pairs run.
//
// Design: three tiers, chosen in one place (`choose` below, exported
// as allwave_dense_forward_design):
//
// * Tier 1, K <= 32 * T1_MAX_LPT: one warp a pair, T1_PAIRS pairs a
//   block, no block barrier. Each thread keeps LPT adjacent lanes of
//   the bands S, I1, D1 (I2, D2 for two-piece penalties) and of the run
//   band in registers; the neighbours at k - 1 and k + 1 come by
//   __shfl_up_sync / __shfl_down_sync.
// * Tier 2, K <= T2_MAX_K: NW warps a pair, one block a pair, the same
//   register lanes and shuffles inside a warp, and at warp edges a
//   double-buffered halo in shared memory (6 ints an edge), so a step
//   needs one __syncthreads. (Tier 3 takes these bands too where the
//   base tables of a pair do not fit shared memory: l_pad above ~110k.)
// * Tier 3, wider bands: one block a pair, the bands double-buffered
//   in shared memory (42 bytes a lane) or, above T3_SMEM_MAX bytes, in
//   a per-pair global scratch that the wrapper allocates; one barrier a
//   step. Only the one-shot 24 kb run and rare escalations reach it.
//
// Tiers 1 and 2 share one kernel. The band's k0 is even and LPT is
// even, so a lane's parity of k is its register index's parity, and
// the step loop runs two steps a turn (odd d, then even d) so that the
// lanes that may move at each step are known at compile time. Lanes at
// c >= K are outside the band: they stay INF and store nothing. A
// lane's activity and diagonal test reduce to one [lo, hi] range of
// register indices a thread and step. The bases a lane reads are the
// clamped indices the XLA shift registers hold (q[v-1] through the
// reversed query, t[h-1]); they are read from a per-pair table of
// those clamped bytes staged in shared memory, or in tier 1 through
// the read-only path where the tables of a block would not fit. A thread
// stores its plane entries 4 or 8 at a time (8- or 16-byte stores) where
// LPT and K allow, else as 32-bit words (16-bit entries when K is odd).
// Plane offsets are 64-bit: D2*B*K passes 2^31 on wide batches.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int T1_PAIRS = 4;       // tier 1: pairs (warps) a block
constexpr int T1_MAX_LPT = 12;    // tier 1: K <= 384
constexpr int T2_MAX_K = 4096;    // tier 2: K <= 4096
constexpr int T3_SMEM_MAX = 200 * 1024;   // tier 3: bands in shared memory
constexpr int SMEM_LIMIT = 227 * 1024;


// tier 2 shapes, narrowest first: {warps a pair, lanes a thread}
constexpr int T2_SHAPES[][2] = {{4, 4}, {4, 6}, {8, 4}, {8, 6},
                                {16, 4}, {16, 6}, {16, 8}};

struct Pen {
  int x, o1e1, e1, o2e2, e2, o1, o2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------
// tier 3: bands in shared memory or a global scratch, one barrier a step

template <bool TWO_PIECE>
__global__ void dense_forward_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    int B, int l_pad, int K, Pen pen, int* __restrict__ scores,
    uint8_t* __restrict__ cert, uint16_t* __restrict__ planes,
    int* iscratch, uint8_t* rscratch) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;

  // band geometry (dense.py _band_geometry): even-aligned k0
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  const int slack = (K - 1 - abs_kend) >> 1;  // floor division by 2
  int k0 = min(0, k_end) - slack;
  k0 -= (k0 & 1);
  const int w_l = min(0, k_end) - k0;
  const int w_r = (k0 + (K - 1)) - max(0, k_end);
  const int width = min(w_l, w_r);

  // bands: [buf][band][K] int32 (S, I1, D1, I2, D2) + [buf][K] run length
  int* ib;
  uint8_t* rb;
  if (iscratch != nullptr) {
    ib = iscratch + (size_t)b * 10 * K;
    rb = rscratch + (size_t)b * 2 * K;
  } else {
    ib = smem;
    rb = reinterpret_cast<uint8_t*>(smem + 10 * K);
  }
#define BAND(buf, band) (ib + ((buf) * 5 + (band)) * K)

  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    BAND(0, 0)[c] = (k0 + c == 0) ? 0 : AW_INF;
    BAND(0, 1)[c] = AW_INF;
    BAND(0, 2)[c] = AW_INF;
    BAND(0, 3)[c] = AW_INF;
    BAND(0, 4)[c] = AW_INF;
    rb[c] = 0;
  }
  __syncthreads();

  const int D2 = 2 * l_pad;
  const size_t plane_stride = (size_t)B * K;
  uint16_t* prow = planes + (size_t)b * K;
  for (int d = 1; d <= D2; ++d) {
    const int pb = (d - 1) & 1;
    const int nb = d & 1;
    const int* S = BAND(pb, 0);
    const int* I1 = BAND(pb, 1);
    const int* D1 = BAND(pb, 2);
    const int* I2 = BAND(pb, 3);
    const int* Dd2 = BAND(pb, 4);
    const uint8_t* R = rb + pb * K;
    int* So = BAND(nb, 0);
    int* I1o = BAND(nb, 1);
    int* D1o = BAND(nb, 2);
    int* I2o = BAND(nb, 3);
    int* D2o = BAND(nb, 4);
    uint8_t* Ro = rb + nb * K;
    uint16_t* plane = prow + (size_t)(d - 1) * plane_stride;

    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const int k = k0 + c;
      const int v = (d - k) >> 1;
      const int h = (d + k) >> 1;
      const bool parity_ok = ((d - k) & 1) == 0;
      const bool active =
          parity_ok && v >= 0 && v <= qlen && h >= 0 && h <= tlen;

      const int s_prev = S[c];
      const int s_km1 = c > 0 ? S[c - 1] : AW_INF;
      const int s_kp1 = c < K - 1 ? S[c + 1] : AW_INF;

      const int i1_ext_v = (c > 0 ? I1[c - 1] : AW_INF) + pen.e1;
      const int i1_opn_v = s_km1 + pen.o1e1;
      const int i1_new = min(i1_opn_v, i1_ext_v);
      const int i1_ext = i1_ext_v <= i1_opn_v;
      const int d1_ext_v = (c < K - 1 ? D1[c + 1] : AW_INF) + pen.e1;
      const int d1_opn_v = s_kp1 + pen.o1e1;
      const int d1_new = min(d1_opn_v, d1_ext_v);
      const int d1_ext = d1_ext_v <= d1_opn_v;
      int best_gap = min(i1_new, d1_new);

      int i2_new = I2[c], d2_new = Dd2[c], i2_ext = 0, d2_ext = 0;
      if (TWO_PIECE) {
        const int i2_ext_v = (c > 0 ? I2[c - 1] : AW_INF) + pen.e2;
        const int i2_opn_v = s_km1 + pen.o2e2;
        i2_new = min(i2_opn_v, i2_ext_v);
        i2_ext = i2_ext_v <= i2_opn_v;
        const int d2_ext_v = (c < K - 1 ? Dd2[c + 1] : AW_INF) + pen.e2;
        const int d2_opn_v = s_kp1 + pen.o2e2;
        d2_new = min(d2_opn_v, d2_ext_v);
        d2_ext = d2_ext_v <= d2_opn_v;
        best_gap = min(best_gap, min(i2_new, d2_new));
      }

      // bases at the clamped indices the XLA shift registers hold:
      // q[v-1] via rq[qlen - v], t[h-1]
      const int qi = clampi(qlen - v, 0, l_pad - 1);
      const uint8_t qb = q[clampi(qlen - 1 - qi, 0, l_pad - 1)];
      const uint8_t tb = t[clampi(h - 1, 0, l_pad - 1)];
      const bool is_match = qb == tb;
      const bool diag_ok = v > 0 && h > 0;
      const int diag = diag_ok ? s_prev + (is_match ? 0 : pen.x) : AW_INF;
      const int s_new = min(diag, best_gap);

      // last write wins: D2 < D1 < I2 < I1 < diag-mismatch
      int choice = 0;
      if (TWO_PIECE && d2_new == s_new) choice = 5;
      if (d1_new == s_new) choice = 4;
      if (TWO_PIECE && i2_new == s_new) choice = 3;
      if (i1_new == s_new) choice = 2;
      if (diag_ok && diag == s_new && !is_match) choice = 1;
      const int packed =
          choice | (i1_ext << 3) | (d1_ext << 4) | (i2_ext << 5) | (d2_ext << 6);
      const int run_prev = R[c];
      const int new_run = choice == 0 ? min(run_prev, 254) + 1 : 0;
      plane[c] = (uint16_t)(packed | (new_run << 8));

      if (active) {
        So[c] = min(s_new, AW_INF);
        I1o[c] = min(i1_new, AW_INF);
        D1o[c] = min(d1_new, AW_INF);
        I2o[c] = min(i2_new, AW_INF);
        D2o[c] = min(d2_new, AW_INF);
        Ro[c] = (uint8_t)new_run;
      } else {
        So[c] = s_prev;
        I1o[c] = I1[c];
        D1o[c] = D1[c];
        I2o[c] = I2[c];
        D2o[c] = Dd2[c];
        Ro[c] = (uint8_t)run_prev;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const int c_end = clampi(k_end - k0, 0, K - 1);
    const bool feasible = abs_kend <= K - 1 && qlen + tlen <= D2;
    const int score = feasible ? BAND(D2 & 1, 0)[c_end] : AW_INF;
    const int n = max(width, 0) + 1;
    const int g1 = pen.o1 + n * pen.e1;
    const int esc = 2 * (TWO_PIECE ? min(g1, pen.o2 + n * pen.e2) : g1);
    const bool full_cover = k0 <= -qlen && k0 + (K - 1) >= tlen;
    scores[b] = score;
    cert[b] = ((score < esc) || full_cover) && feasible && score < AW_INF;
  }
#undef BAND
}

// ---------------------------------------------------------------------
// tiers 1 and 2: bands in registers

// floor(a / 2) of a compile-time constant
__host__ __device__ constexpr int fl2(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

// the clamped base indices of dense_forward_ref's shift registers:
// q[clamp(qlen-1 - clamp(qlen - v, 0, l_pad-1), 0, l_pad-1)] is
// q[clamp(v - 1, 0, max(qlen - 1, 0))] for 0 <= qlen <= l_pad
__device__ __forceinline__ int q_index(int v, int qhi) {
  return min(max(v - 1, 0), qhi);
}
__device__ __forceinline__ int t_index(int h, int thi) {
  return min(max(h - 1, 0), thi);
}

// a thread's LPT plane entries, as words w[r / 2] (entry r in the low
// half when r is even), at pd: CH lanes a store where K allows the
// alignment, else 32-bit words (K even) or 16-bit entries; r < nin only
template <int LPT>
__device__ __forceinline__ void store_entries(uint16_t* pd, const uint32_t (&w)[LPT / 2],
                                              int nin, int K) {
  constexpr int CH = LPT % 8 == 0 ? 8 : (LPT % 4 == 0 ? 4 : 2);
  if (K % CH == 0) {
#pragma unroll
    for (int j = 0; j < LPT; j += CH) {
      if (j + CH > nin) continue;
      if constexpr (CH == 8)
        *reinterpret_cast<uint4*>(pd + j) =
            make_uint4(w[j / 2], w[j / 2 + 1], w[j / 2 + 2], w[j / 2 + 3]);
      else if constexpr (CH == 4)
        *reinterpret_cast<uint2*>(pd + j) = make_uint2(w[j / 2], w[j / 2 + 1]);
      else
        *reinterpret_cast<uint32_t*>(pd + j) = w[j / 2];
    }
  } else if ((K & 1) == 0) {
#pragma unroll
    for (int j = 0; j < LPT; j += 2)
      if (j + 2 <= nin) *reinterpret_cast<uint32_t*>(pd + j) = w[j / 2];
  } else {
#pragma unroll
    for (int r = 0; r < LPT; ++r)
      if (r < nin) pd[r] = (uint16_t)(w[r / 2] >> (16 * (r & 1)));
  }
}

// blocks of 128 threads a tier-1 SM must hold, which caps a thread's
// registers at 65536 / (128 * blocks): 4 blocks (128 registers) where
// ptxas then spills nothing; the read-only variant at 8 lanes spills
// at 128, and 10-12 lanes need more
constexpr int t1_min_blocks(int lpt, bool stage) {
  return lpt > 8 ? 2 : (lpt == 8 && !stage ? 3 : 4);
}

// T2 false (tier 1): warp w of a block runs pair blockIdx.x * T1_PAIRS + w.
// T2 true (tier 2): the block of nw warps runs pair blockIdx.x, warp w
// its lanes c = (w * 32 + lane) * LPT + r. tbl: bytes of each staged
// base table.
template <int LPT, bool TWO, bool STAGE, bool T2>
__global__ void __launch_bounds__(T2 ? 512 : 32 * T1_PAIRS, T2 ? 1 : t1_min_blocks(LPT, STAGE))
    dense_forward_regs_kernel(
        const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
        const int* __restrict__ qlens, const int* __restrict__ tlens, int B,
        int l_pad, int K, int nw, int tbl, Pen pen, int* __restrict__ scores,
        uint8_t* __restrict__ cert, uint16_t* __restrict__ planes) {
  static_assert(LPT % 2 == 0, "a lane's parity of k is its index's");
  static_assert(STAGE || !T2, "tier 2 stages its base tables");
  extern __shared__ __align__(16) uint8_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = T2 ? blockIdx.x : blockIdx.x * T1_PAIRS + warp;
  const int wp = T2 ? warp : 0;  // the warp's place in its pair
  if (!T2 && b >= B) return;  // a whole warp, no block barrier follows
  // [2 buffers][nw][6]: a warp's last lane (S, I1, I2), first (S, D1, D2)
  int* halo = reinterpret_cast<int*>(sm);
  uint8_t* qt = T2 ? sm + 48 * nw : sm + warp * 2 * tbl;
  uint8_t* tt = qt + tbl;
#define HALO(buf, w) (halo + ((buf) * nw + (w)) * 6)

  const int qlen = qlens[b], tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;
  // band geometry (dense.py _band_geometry): even-aligned k0
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  const int slack = (K - 1 - abs_kend) >> 1;  // floor division by 2
  int k0 = min(0, k_end) - slack;
  k0 -= (k0 & 1);
  const int width = min(min(0, k_end) - k0, (k0 + (K - 1)) - max(0, k_end));

  const int c0 = (wp * 32 + lane) * LPT;
  const int kb = k0 + c0;  // even: lane r has k = kb + r
  const int kc = nw * 32 * LPT;
  const int qhi = max(qlen - 1, 0), thi = l_pad - 1;
  // the tables hold the bytes at v = vmin .., h = hmin ..: every (d, k)
  // with 1 <= d <= 2 l_pad and k0 <= k < k0 + kc
  const int vmin = (2 - k0 - kc) >> 1, hmin = (1 + k0) >> 1;
  if (STAGE) {
    for (int i = wp * 32 + lane; i < tbl; i += nw * 32) {
      qt[i] = q[q_index(vmin + i, qhi)];
      tt[i] = t[t_index(hmin + i, thi)];
    }
  }

  int S[LPT], I1[LPT], D1[LPT], I2[TWO ? LPT : 1], D2[TWO ? LPT : 1], R[LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    S[r] = (c0 + r < K && kb + r == 0) ? 0 : AW_INF;
    I1[r] = D1[r] = AW_INF;
    if (TWO) I2[r] = D2[r] = AW_INF;
    R[r] = 0;
  }
  if (T2) {
    int* h = HALO(0, wp);
    if (lane == 31) {
      h[0] = S[LPT - 1];
      h[1] = h[2] = AW_INF;
    }
    if (lane == 0) {
      h[3] = S[0];
      h[4] = h[5] = AW_INF;
    }
    __syncthreads();
  } else {
    __syncwarp();
  }

  const int D2n = 2 * l_pad;
  const int q2 = 2 * qlen, t2 = 2 * tlen;
  const int nin = K - c0;  // register r is inside the band iff r < nin
  const size_t pstride = (size_t)B * K;
  uint16_t* pd = planes + (size_t)b * K + c0;  // the row of step d

  for (int d0 = 1; d0 <= D2n; d0 += 2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool odd = half == 0;  // d odd: the odd registers may move
      const int d = d0 + half;
      const int x = d - kb, y = d + kb;
      // lane r moves iff its parity is d's and lo <= r <= hi:
      // |k| <= d <= min(k + 2 qlen, 2 tlen - k), inside the band
      const int lo = max(-y, x - q2);
      const int hi = min(min(x, t2 - y), nin - 1);
      // the diagonal term exists iff v > 0 and h > 0: |k| + 2 <= d
      const int dlo = 2 - y, dhi = x - 2;

      // neighbours at k - 1 (S, I1, I2) and k + 1 (S, D1, D2): INF past
      // the band's ends, from the halo (written by the step before) at
      // a tier-2 warp's ends
      int sl = __shfl_up_sync(FULL, S[LPT - 1], 1);
      int i1l = __shfl_up_sync(FULL, I1[LPT - 1], 1);
      int sr = __shfl_down_sync(FULL, S[0], 1);
      int d1r = __shfl_down_sync(FULL, D1[0], 1);
      int i2l = AW_INF, d2r = AW_INF;
      if (TWO) {
        i2l = __shfl_up_sync(FULL, I2[LPT - 1], 1);
        d2r = __shfl_down_sync(FULL, D2[0], 1);
      }
      if (T2) {
        if (lane == 0) {
          const int* h = HALO(half, max(wp - 1, 0));
          sl = wp > 0 ? h[0] : AW_INF;
          i1l = wp > 0 ? h[1] : AW_INF;
          i2l = wp > 0 ? h[2] : AW_INF;
        }
        if (lane == 31) {
          const int* h = HALO(half, min(wp + 1, nw - 1));
          sr = wp < nw - 1 ? h[3] : AW_INF;
          d1r = wp < nw - 1 ? h[4] : AW_INF;
          d2r = wp < nw - 1 ? h[5] : AW_INF;
        }
      } else {
        sl = lane == 0 ? AW_INF : sl;
        i1l = lane == 0 ? AW_INF : i1l;
        i2l = lane == 0 ? AW_INF : i2l;
        sr = lane == 31 ? AW_INF : sr;
        d1r = lane == 31 ? AW_INF : d1r;
        d2r = lane == 31 ? AW_INF : d2r;
      }

      const uint8_t* qp = qt + ((x >> 1) - vmin);
      const uint8_t* tp = tt + ((y >> 1) - hmin);
      int nS[LPT], nI1[LPT], nD1[LPT], nI2[TWO ? LPT : 1], nD2[TWO ? LPT : 1],
          nR[LPT];
      uint32_t w[LPT / 2];
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        const int s_km1 = r > 0 ? S[r - 1] : sl;
        const int s_kp1 = r < LPT - 1 ? S[r + 1] : sr;
        const int i1e = (r > 0 ? I1[r - 1] : i1l) + pen.e1;
        const int i1o = s_km1 + pen.o1e1;
        const int i1n = min(i1o, i1e);
        const int d1e = (r < LPT - 1 ? D1[r + 1] : d1r) + pen.e1;
        const int d1o = s_kp1 + pen.o1e1;
        const int d1n = min(d1o, d1e);
        int i2n = AW_INF, d2n = AW_INF, i2x = 0, d2x = 0;
        if (TWO) {
          const int i2e = (r > 0 ? I2[r - 1] : i2l) + pen.e2;
          const int i2o = s_km1 + pen.o2e2;
          i2n = min(i2o, i2e);
          i2x = i2e <= i2o;  // a tie extends
          const int d2e = (r < LPT - 1 ? D2[r + 1] : d2r) + pen.e2;
          const int d2o = s_kp1 + pen.o2e2;
          d2n = min(d2o, d2e);
          d2x = d2e <= d2o;
        }
        // the best gap and its code, a tie to the earlier of I1 < I2 <
        // D1 < D2 (the last write wins in D2, D1, I2, I1 order)
        int best, code;
        if (TWO) {
          const int bi = min(i1n, i2n), bd = min(d1n, d2n);
          best = min(bi, bd);
          code = bi <= bd ? (i1n <= i2n ? 2 : 3) : (d1n <= d2n ? 4 : 5);
        } else {
          best = min(i1n, d1n);
          code = i1n <= d1n ? 2 : 4;
        }
        // v = (x - r) >> 1 and h = (y + r) >> 1, x and y of d's parity
        const int qo = odd ? fl2(1 - r) : fl2(-r);
        const int to = odd ? fl2(1 + r) : fl2(r);
        uint8_t qb, tb;
        if (STAGE) {
          qb = qp[qo];
          tb = tp[to];
        } else {
          qb = __ldg(q + q_index((x >> 1) + qo, qhi));
          tb = __ldg(t + t_index((y >> 1) + to, thi));
        }
        const bool match = qb == tb;
        const bool diag_ok = r >= dlo && r <= dhi;
        const int diag = diag_ok ? S[r] + (match ? 0 : pen.x) : AW_INF;
        const int sn = min(diag, best);

        // diag-mismatch over any gap, a gap over a diagonal match
        const int choice = diag <= best && diag_ok && !match ? 1 : (best == sn ? code : 0);
        const int packed = choice | ((i1e <= i1o) << 3) | ((d1e <= d1o) << 4) |
                           (i2x << 5) | (d2x << 6);
        const int newrun = choice == 0 ? min(R[r], 254) + 1 : 0;
        const uint32_t entry = (uint32_t)(packed | (newrun << 8));
        if (r & 1)
          w[r / 2] |= entry << 16;
        else
          w[r / 2] = entry;

        const bool active = (((r & 1) != 0) == odd) && r >= lo && r <= hi;
        nS[r] = active ? min(sn, AW_INF) : S[r];
        nI1[r] = active ? min(i1n, AW_INF) : I1[r];
        nD1[r] = active ? min(d1n, AW_INF) : D1[r];
        if (TWO) {
          nI2[r] = active ? min(i2n, AW_INF) : I2[r];
          nD2[r] = active ? min(d2n, AW_INF) : D2[r];
        }
        nR[r] = active ? newrun : R[r];
      }
      store_entries<LPT>(pd, w, nin, K);
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        S[r] = nS[r];
        I1[r] = nI1[r];
        D1[r] = nD1[r];
        if (TWO) {
          I2[r] = nI2[r];
          D2[r] = nD2[r];
        }
        R[r] = nR[r];
      }
      if (T2) {
        int* h = HALO(half ^ 1, wp);
        if (lane == 31) {
          h[0] = S[LPT - 1];
          h[1] = I1[LPT - 1];
          h[2] = TWO ? I2[LPT - 1] : AW_INF;
        }
        if (lane == 0) {
          h[3] = S[0];
          h[4] = D1[0];
          h[5] = TWO ? D2[0] : AW_INF;
        }
        __syncthreads();
      }
      pd += pstride;
    }
  }

  const int c_end = clampi(k_end - k0, 0, K - 1);
  if (c_end >= c0 && c_end < c0 + LPT) {
    int s = AW_INF;
#pragma unroll
    for (int r = 0; r < LPT; ++r)
      if (c0 + r == c_end) s = S[r];
    const bool feasible = abs_kend <= K - 1 && qlen + tlen <= D2n;
    const int score = feasible ? s : AW_INF;
    const int n = max(width, 0) + 1;
    const int g1 = pen.o1 + n * pen.e1;
    const int esc = 2 * (TWO ? min(g1, pen.o2 + n * pen.e2) : g1);
    const bool full_cover = k0 <= -qlen && k0 + (K - 1) >= tlen;
    scores[b] = score;
    cert[b] = ((score < esc) || full_cover) && feasible && score < AW_INF;
  }
#undef HALO
}

// ---------------------------------------------------------------------
// the dispatch

struct Design {
  int tier;   // 1, 2 or 3
  int lpt;    // lanes a thread (tiers 1-2)
  int nw;     // warps a pair (tiers 1-2)
  int stage;  // base tables staged in shared memory (tiers 1-2)
  int scratch;  // bands in the global scratch (tier 3)
};

int table_bytes(const Design& g, int l_pad) {
  // l_pad + kc/2 + 2 bytes cover every v (and h) a pair's lanes read
  const int kc = g.nw * 32 * g.lpt;
  return ((l_pad + kc / 2 + 2) + 15) / 16 * 16;
}

// tiers 1-2: the halo (tier 2) and the staged tables of a block
int smem_bytes(const Design& g, int l_pad) {
  if (g.tier == 1) return g.stage ? T1_PAIRS * 2 * table_bytes(g, l_pad) : 0;
  return 48 * g.nw + (g.stage ? 2 * table_bytes(g, l_pad) : 0);
}

// stage (tier 1): -1 where the tables fit shared memory, 0 never, 1
// always. Tier 2 stages its tables (its read-only instantiations would
// spill at 8 lanes a thread); where they do not fit shared memory (l_pad
// above ~110k), tier 3 takes the band. Returns false for a design that
// cannot run.
bool choose(int K, int l_pad, int stage, Design* g) {
  *g = Design{0, 0, 0, 0, 0};
  if (K < 1 || l_pad < 1) return false;
  if (K <= 32 * T1_MAX_LPT) {
    g->tier = 1;
    g->nw = 1;
    g->lpt = 4;
    while (32 * g->lpt < K) g->lpt += 2;
    g->stage = 1;
    const bool fits = smem_bytes(*g, l_pad) <= SMEM_LIMIT;
    if (stage == 1 && !fits) return false;
    g->stage = stage == -1 ? fits : stage;
    return true;
  }
  if (K <= T2_MAX_K) {
    g->tier = 2;
    g->stage = 1;
    for (const auto& s : T2_SHAPES) {
      if (s[0] * 32 * s[1] >= K) {
        g->nw = s[0];
        g->lpt = s[1];
        break;
      }
    }
    if (smem_bytes(*g, l_pad) <= SMEM_LIMIT) return stage != 0;
    *g = Design{0, 0, 0, 0, 0};
  }
  g->tier = 3;
  g->scratch = 42 * K > T3_SMEM_MAX;
  return stage != 1;
}

int encode(const Design& g) {
  return g.tier | (g.lpt << 2) | (g.nw << 8) | (g.stage << 16) |
         (g.scratch << 17);
}

template <int LPT, bool TWO, bool T2>
int launch_regs(const Design& g, const void* qs, const void* ts,
                const void* qlens, const void* tlens, int B, int l_pad, int K,
                Pen pen, void* scores, void* cert, void* planes,
                cudaStream_t st) {
  const int smem = smem_bytes(g, l_pad);
  const int tbl = table_bytes(g, l_pad);
  const int threads = T2 ? 32 * g.nw : 32 * T1_PAIRS;
  const int grid = T2 ? B : (B + T1_PAIRS - 1) / T1_PAIRS;
#define AW_GO(STAGE)                                                         \
  {                                                                          \
    auto* kern = dense_forward_regs_kernel<LPT, TWO, STAGE, T2>;             \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                         smem);                                              \
    kern<<<grid, threads, smem, st>>>(                                       \
        static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),    \
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), B,   \
        l_pad, K, g.nw, tbl, pen, static_cast<int*>(scores),                 \
        static_cast<uint8_t*>(cert), static_cast<uint16_t*>(planes));        \
  }
  if constexpr (T2) {
    AW_GO(true)
  } else if (g.stage) {
    AW_GO(true)
  } else {
    AW_GO(false)
  }
#undef AW_GO
  return (int)cudaGetLastError();
}

template <bool TWO>
int launch_tiers12(const Design& g, const void* qs, const void* ts,
                   const void* qlens, const void* tlens, int B, int l_pad,
                   int K, Pen pen, void* scores, void* cert, void* planes,
                   cudaStream_t st) {
#define AW_LPT(N, T2)                                                       \
  case N:                                                                   \
    return launch_regs<N, TWO, T2>(g, qs, ts, qlens, tlens, B, l_pad, K,    \
                                   pen, scores, cert, planes, st);
  if (g.tier == 1) {
    switch (g.lpt) {
      AW_LPT(4, false)
      AW_LPT(6, false)
      AW_LPT(8, false)
      AW_LPT(10, false)
      AW_LPT(12, false)
    }
  } else {
    switch (g.lpt) {
      AW_LPT(4, true)
      AW_LPT(6, true)
      AW_LPT(8, true)
    }
  }
#undef AW_LPT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The design a launch at band K and l_pad runs, as a code: bits 0-1 the
// tier (1-3), 2-7 lanes a thread and 8-15 warps a pair (tiers 1-2), bit
// 16 base tables staged in shared memory (tiers 1-2), bit 17 bands in
// the global scratch (tier 3: the wrapper allocates it). stage_bases:
// -1 the dispatch's choice, 0 or 1 to read bases through the read-only
// path or from the staged tables (tiers 1-2). -1 for a design that
// cannot run.
int allwave_dense_forward_design(int K, int l_pad, int stage_bases) {
  Design g;
  if (!choose(K, l_pad, stage_bases, &g)) return -1;
  return encode(g);
}

// design: a code of allwave_dense_forward_design for this K and l_pad.
// iscratch (B, 10, K) int32 and rscratch (B, 2, K) uint8 where the
// design's bit 17 is set, else null.
int allwave_dense_forward(const void* qs, const void* ts, const void* qlens,
                          const void* tlens, int B, int l_pad, int K, int x,
                          int o1, int e1, int o2, int e2, int two_piece,
                          int design, void* scores, void* cert, void* planes,
                          void* iscratch, void* rscratch, void* stream) {
  Pen pen;
  pen.x = x;
  pen.o1 = o1;
  pen.e1 = e1;
  pen.o2 = o2;
  pen.e2 = e2;
  pen.o1e1 = o1 + e1;
  pen.o2e2 = two_piece ? o2 + e2 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Design g;
  bool ok = false;
  for (int stage = 0; stage <= 1 && !ok; ++stage)
    ok = choose(K, l_pad, stage, &g) && encode(g) == design;
  if (!ok || (g.scratch != 0) != (iscratch != nullptr) ||
      (iscratch != nullptr) != (rscratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (g.tier != 3) {
    return two_piece ? launch_tiers12<true>(g, qs, ts, qlens, tlens, B, l_pad,
                                            K, pen, scores, cert, planes, st)
                     : launch_tiers12<false>(g, qs, ts, qlens, tlens, B, l_pad,
                                             K, pen, scores, cert, planes, st);
  }
  const int threads = K >= 1024 ? 1024 : ((K + 31) / 32) * 32;
  const int smem = g.scratch ? 0 : 42 * K;
  if (two_piece) {
    cudaFuncSetAttribute(dense_forward_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dense_forward_kernel<true><<<B, threads, smem, st>>>(
        static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), B,
        l_pad, K, pen, static_cast<int*>(scores), static_cast<uint8_t*>(cert),
        static_cast<uint16_t*>(planes), static_cast<int*>(iscratch),
        static_cast<uint8_t*>(rscratch));
  } else {
    cudaFuncSetAttribute(dense_forward_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dense_forward_kernel<false><<<B, threads, smem, st>>>(
        static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), B,
        l_pad, K, pen, static_cast<int*>(scores), static_cast<uint8_t*>(cert),
        static_cast<uint16_t*>(planes), static_cast<int*>(iscratch),
        static_cast<uint8_t*>(rscratch));
  }
  return (int)cudaGetLastError();
}

const char* allwave_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
