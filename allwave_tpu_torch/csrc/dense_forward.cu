// Banded Gotoh forward sweep over anti-diagonals, with the merged
// choice/run-length traceback plane.
//
// Replaces: allwave_tpu/wfa/pallas_dense.py `_forward_t` (kernel
// `_kernel_t` / `run_dp_chunk_t`, K <= 2048) and `_forward_c2` (kernel
// `_kernel_c2` / `run_dp_chunk_c2`, the escalation bands 2048 < K <=
// 16384). Both compute the function of allwave_tpu/wfa/dense.py
// `dense_forward`; they differ only in TPU layout, so one dispatch
// serves every K here. Its plain twin is allwave_tpu_torch/wfa/dense.py
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
// * Tier 3, wider bands: a thread-block cluster a pair, the replay
//   cluster of csrc/dense_span.cu (`dense_replay_cluster_kernel`, its
//   design from allwave_dense_span_design over the full band: up to 16
//   blocks of 4-12 warps, 4 or 8 band lanes a thread in registers, halos
//   over distributed shared memory, base tables restaged every 4096
//   steps) run over the window W = K from d = 0 and the origin state
//   (S = 0 at k = 0, INF elsewhere, runs 0). Its plane rows are the
//   forward's (row stride B*K), and every lane writes its entry every
//   step from the values its neighbours held before the step, as here.
//   The wrapper (wfa/dense.py `dense_forward`) launches it, then
//   `dense_forward_finish_kernel` below: the scores and certificates
//   from its end state's S band. No band lives in device memory.
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
// tier 3's epilogue: a thread a pair

// The score at c_end of the end state's S band (INF where the end cell
// is outside the band or the matrix) and the optimality certificate
// (dense.py dense_forward: a band-escaping path costs at least twice
// g(width + 1); a band covering every diagonal is the unbanded DP).
__global__ void dense_forward_finish_kernel(const int* __restrict__ qlens,
                                            const int* __restrict__ tlens, int B,
                                            int l_pad, int K, Pen pen, bool two_piece,
                                            const int* __restrict__ s_band,
                                            int* __restrict__ scores,
                                            uint8_t* __restrict__ cert) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int qlen = qlens[b], tlen = tlens[b];
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  int k0 = min(0, k_end) - ((K - 1 - abs_kend) >> 1);
  k0 -= (k0 & 1);
  const int width = min(min(0, k_end) - k0, (k0 + (K - 1)) - max(0, k_end));
  const int c_end = clampi(k_end - k0, 0, K - 1);
  const bool feasible = abs_kend <= K - 1 && qlen + tlen <= 2 * l_pad;
  const int score = feasible ? s_band[(size_t)b * K + c_end] : AW_INF;
  const int n = max(width, 0) + 1;
  const int g1 = pen.o1 + n * pen.e1;
  const int esc = 2 * (two_piece ? min(g1, pen.o2 + n * pen.e2) : g1);
  const bool full_cover = k0 <= -qlen && k0 + (K - 1) >= tlen;
  scores[b] = score;
  cert[b] = ((score < esc) || full_cover) && feasible && score < AW_INF;
}

// ---------------------------------------------------------------------
// the dispatch

struct Design {
  int tier;   // 1, 2 or 3
  int lpt;    // lanes a thread (tiers 1-2)
  int nw;     // warps a pair (tiers 1-2)
  int stage;  // base tables staged in shared memory (tiers 1-2)
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
// cannot run. Tier 3's cluster is the span's dispatch's.
bool choose(int K, int l_pad, int stage, Design* g) {
  *g = Design{0, 0, 0, 0};
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
    *g = Design{0, 0, 0, 0};
  }
  g->tier = 3;
  g->stage = 1;  // the replay's tables, a stretch of steps at a time
  return stage != 0;
}

int encode(const Design& g) {
  return g.tier | (g.lpt << 2) | (g.nw << 8) | (g.stage << 16);
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
// 16 base tables staged in shared memory (tiers 1-2). stage_bases: -1
// the dispatch's choice, 0 or 1 to read bases through the read-only
// path or from the staged tables (tiers 1-2; tiers 2-3 always stage).
// -1 for a design that cannot run. Tier 3 runs csrc/dense_span.cu's
// replay cluster, whose design is allwave_dense_span_design(K, K, 1, B,
// two_piece).
int allwave_dense_forward_design(int K, int l_pad, int stage_bases) {
  Design g;
  if (!choose(K, l_pad, stage_bases, &g)) return -1;
  return encode(g);
}

// Tiers 1-2. design: a code of allwave_dense_forward_design for this K
// and l_pad.
int allwave_dense_forward(const void* qs, const void* ts, const void* qlens,
                          const void* tlens, int B, int l_pad, int K, int x,
                          int o1, int e1, int o2, int e2, int two_piece,
                          int design, void* scores, void* cert, void* planes,
                          void* stream) {
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
  if (!ok || g.tier == 3) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  return two_piece ? launch_tiers12<true>(g, qs, ts, qlens, tlens, B, l_pad, K,
                                          pen, scores, cert, planes, st)
                   : launch_tiers12<false>(g, qs, ts, qlens, tlens, B, l_pad, K,
                                           pen, scores, cert, planes, st);
}

// Tier 3's epilogue: scores (B,) int32 and cert (B,) uint8 from the
// replay cluster's end state, whose S band s_band (B, K) int32 is the
// state at d = 2 l_pad.
int allwave_dense_forward_finish(const void* qlens, const void* tlens, int B,
                                 int l_pad, int K, int o1, int e1, int o2,
                                 int e2, int two_piece, const void* s_band,
                                 void* scores, void* cert, void* stream) {
  if (B <= 0) return 0;
  Pen pen = {};
  pen.o1 = o1;
  pen.e1 = e1;
  pen.o2 = o2;
  pen.e2 = e2;
  const int threads = 128;
  dense_forward_finish_kernel<<<(B + threads - 1) / threads, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qlens), static_cast<const int*>(tlens), B, l_pad, K, pen,
      two_piece != 0, static_cast<const int*>(s_band), static_cast<int*>(scores),
      static_cast<uint8_t*>(cert));
  return (int)cudaGetLastError();
}

const char* allwave_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
