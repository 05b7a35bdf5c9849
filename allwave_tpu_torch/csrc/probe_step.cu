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
// as the JAX code's do. Only the lanes of d's parity inside
// [max(d - q2, -d), min(q2 - d, d)] move at d, and they read only their
// own S and the lanes c - 1 and c + 1, of the other parity, which do
// not move at d.
//
// What bounds it on an H100: every step depends on the one before, and
// a problem is one block, so at the experiments' TB = 8 or 16 problems
// only 8 or 16 of the 132 SMs work: a step costs its dependent chain
// (the neighbour exchange, ~8 dependent ALU and DPX instructions, the
// block's barrier) plus what one SM issues for it, far below the
// card's int32 rate. The plane stores of x6 (2 to 4 bytes a lane and
// step, 0.27-0.54 GB at TB = 16, K = 2048, 4096 steps) are 0.08-0.16 ms
// of HBM; what they cost is their issue on 16 SMs.
//
// Design: two kernels, neither of which computes the recurrence of the
// parity that does not move (x6's plane entries are computed for every
// lane, as the plane holds one a lane and step).
// * step_smem_kernel (x4 v0: the state in scratch): one block a
//   problem, one thread a lane of the moving parity (ceil(K / 2)
//   threads). The five bands are parity-packed in shared memory (lane
//   c = 2j + p at [p][j + 1], its five values side by side: an odd
//   stride, so a warp's reads hit distinct banks, and every access a
//   fixed offset from one of two pointers; INF slots at both ends) and
//   updated in place: the moving parity reads the other one, which does
//   not move, so one __syncthreads a step and no double buffer. Both
//   stream registers sit in shared memory twice over, parity-packed
//   too, so that a thread reads its stream value at offset + c with the
//   offset moved by one a step (offset + p keeps its parity, so a
//   warp's reads are consecutive).
// * step_regs_kernel (x4 v1-v4, every x5 variant, every x6 mode): 256
//   threads a problem, each keeping LPT = K / 256 adjacent lanes of the
//   bands (and x6's run band) in registers. The step loop runs from a
//   start parity fixed at compile time (dispatched once a launch), so
//   with even LPT a register's parity is its index's and only the
//   moving registers are computed; with odd LPT (K = 256) the moving
//   registers depend on the thread's parity. A step exchanges one side
//   only: its neighbours inside a warp come by one direction of
//   __shfl_up_sync or __shfl_down_sync, and at warp edges from a halo
//   in shared memory, one 16-byte slot a warp and side (a warp's last
//   lane after an odd step, its first lane after an even one; INF slots
//   beyond both ends; each side double-buffered by step pair, so that
//   x6's idle lanes read their pre-step values while the neighbour warp
//   writes its new ones); one barrier a step. The step has no branch
//   but a warp vote that skips warps with no lane in [lo, hi]: a moving
//   register commits by predicate. The stream values ride in
//   registers: a step shifts them by one lane and loads the entering
//   one from the rows in shared memory (stored skewed, x + x / 32, so
//   threads LPT apart read distinct banks). The unroll (2, 4, 8) and
//   v4's two interleaved problems are template parameters. A launch
//   runs steps n0 .. n0 + n_steps - 1 in chunks: the state comes from
//   s_in at n0 == 0, else from a (5, TB, K) device buffer, and goes back
//   to it; the S band goes out after every chunk and/or after the last,
//   and as uint8 to x5's dummy output. x6 computes each lane's plane
//   entry from the pre-step values before the moving lanes commit, and
//   stores a thread's LPT entries of a row in 16-, 8-, 4- or 2-byte
//   vector stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = (1 << 30) - 1;
constexpr int O1E1 = 10, E1 = 2, O2E2 = 25, E2 = 1, XP = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM_K = 2048;  // v0: one thread a lane pair

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct Terms {
  int i1n, d1n, i2n, d2n, sn, diag;
  bool i1x, d1x, i2x, d2x, match;
};

// kexp6.py step_math at one lane: own S; the left neighbour's S, I1, I2
// and the right one's S, D1, D2 (INF at the band's edges); the two
// stream values; whether the diagonal term exists (2 - d <= c <= d - 2)
__device__ __forceinline__ Terms step_terms(int s, int sl, int i1l, int i2l,
                                            int sr, int d1r, int d2r, int qv,
                                            int tv, bool diag_ok) {
  Terms t;
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
  t.diag = diag_ok ? wadd(s, t.match ? 0 : XP) : INF;
  t.sn = min(t.diag, best);
  return t;
}

// kexp8.py's plane entry (choice codes, last write wins; the extend
// flags in bits 3-6; the match run in bits 8-15) and the new run
__device__ __forceinline__ int plane_entry(const Terms& t, int runp, int& newrun) {
  int choice = 0;
  if (t.d2n == t.sn) choice = 5;
  if (t.d1n == t.sn) choice = 3;
  if (t.i2n == t.sn) choice = 4;
  if (t.i1n == t.sn) choice = 2;
  if (t.diag == t.sn && !t.match) choice = 1;
  newrun = choice == 0 ? min(runp, 254) + 1 : 0;
  return choice | (t.i1x << 3) | (t.d1x << 4) | (t.i2x << 5) | (t.d2x << 6) |
         (newrun << 8);
}

// the lanes that move at d: [lo, hi] (the parity test is the caller's)
__device__ __forceinline__ int lane_lo(int d, int q2) { return max(d - q2, -d); }
__device__ __forceinline__ int lane_hi(int d, int q2) { return min(q2 - d, d); }

// ---------------------------------------------------------------------
// x4 v0: parity-packed bands in shared memory, updated in place

// The bands of lane c = 2j + p at band[p][j + 1][0..4] (S, I1, D1, I2,
// D2; BANDS = 5 ints a lane, an odd stride, so a warp's lanes read distinct
// banks), with INF in slots 0 and KH + 1 of each parity (the neighbours
// beyond lane 0 and lane K - 1, never written): a thread reads and
// writes every value at a fixed offset from two pointers.
constexpr int BANDS = 5;

template <int P>  // the moving parity (d & 1)
__device__ __forceinline__ void smem_step(int* const (&lanes)[2], const int* qj,
                                          const int* tj, int c, int lo, int hi,
                                          int d, int L, int pq, int pt) {
  constexpr int O = P ^ 1;
  if (c >= lo && c <= hi) {
    // c - 1 and c + 1, of the other parity: slots j - 1 + P and j + P
    const int* l = lanes[O] + BANDS * (P - 1);
    const int* r = lanes[O] + BANDS * P;
    int* w = lanes[P];
    // stream positions pq + c and pt + c: their parity is that of
    // pq + P (pt + P), and they lie at [parity][(pq + P) / 2 + j]
    const int xq = pq + P, xt = pt + P;
    const int qv = qj[(xq & 1) * L + (xq >> 1)];
    const int tv = tj[(xt & 1) * L + (xt >> 1)];
    const Terms t = step_terms(w[0], l[0], l[1], l[3], r[0], r[2], r[4], qv, tv,
                               c <= d - 2 && c >= 2 - d);
    w[0] = t.sn;
    w[1] = t.i1n;
    w[2] = t.d1n;
    w[3] = t.i2n;
    w[4] = t.d2n;
  }
}

__global__ void __launch_bounds__(1024) step_smem_kernel(
    const int* __restrict__ qb0, const int* __restrict__ tb0,
    const int* __restrict__ s_in, int K, int W, int fill, int q2, int n_steps,
    int* __restrict__ sout) {
  extern __shared__ __align__(16) int sm[];
  const int L = W + K, KH = (K + 1) >> 1, KP = KH + 2;
  int* band = sm;                     // [2][KP][BANDS]
  int* qrow = band + 2 * KP * BANDS;  // [2][L]: position x of the doubled row
  int* trow = qrow + 2 * L;           //   at [x & 1][x >> 1]
  const size_t row = (size_t)blockIdx.x * K;
  const int j = threadIdx.x;

  for (int x = j; x < L; x += blockDim.x) {
    const int qv = x < W ? fill : qb0[row + x - W];
    const int tv = x < K ? tb0[row + x] : fill;
    const int x2 = x + L;
    qrow[(x & 1) * L + (x >> 1)] = qv;
    qrow[(x2 & 1) * L + (x2 >> 1)] = qv;
    trow[(x & 1) * L + (x >> 1)] = tv;
    trow[(x2 & 1) * L + (x2 >> 1)] = tv;
  }
  for (int x = j; x < 2 * KP * BANDS; x += blockDim.x) {
    const int jj = (x / BANDS) % KP - 1, c = 2 * jj + x / (KP * BANDS);
    band[x] = x % BANDS == 0 && jj >= 0 && jj < KH && c < K ? s_in[row + c] : INF;
  }
  __syncthreads();

  int* const lanes[2] = {band + BANDS * (j + 1), band + BANDS * (KP + j + 1)};
  const int* qj = qrow + j;
  const int* tj = trow + j;
  // stream offsets after the first step's rotation
  int pq = ((W - 1) % L + L) % L, pt = 1 % L;
  // d = g + 2: even at even g. Lanes past K - 1 never move.
  int g = 0;
  for (; g + 1 < n_steps; g += 2) {
    const int d = g + 2;
    smem_step<0>(lanes, qj, tj, 2 * j, lane_lo(d, q2), min(lane_hi(d, q2), K - 1), d, L, pq, pt);
    __syncthreads();
    pq = pq == 0 ? L - 1 : pq - 1;
    pt = pt == L - 1 ? 0 : pt + 1;
    smem_step<1>(lanes, qj, tj, 2 * j + 1, lane_lo(d + 1, q2), min(lane_hi(d + 1, q2), K - 1),
                 d + 1, L, pq, pt);
    __syncthreads();
    pq = pq == 0 ? L - 1 : pq - 1;
    pt = pt == L - 1 ? 0 : pt + 1;
  }
  if (g < n_steps) {
    smem_step<0>(lanes, qj, tj, 2 * j, lane_lo(g + 2, q2), min(lane_hi(g + 2, q2), K - 1), g + 2,
                 L, pq, pt);
    __syncthreads();
  }
  for (int c = j; c < K; c += blockDim.x)
    sout[row + c] = band[BANDS * ((c & 1) * KP + (c >> 1) + 1)];
}

// ---------------------------------------------------------------------
// register bands (x4 v1-v4, x5, x6)

constexpr int REG_THREADS = 256;
constexpr int REG_WARPS = REG_THREADS / 32;

struct StepArgs {
  const int* qb0;
  const int* tb0;
  const int* s_in;
  int TB, K, W, fill, q2, n0, n_steps, chunk;
  int* state;       // (5, TB, K) or null
  const int* base;  // one int32 or null (0)
  int* sout;
  int sout_every, sout_last;
  uint8_t* dummy;  // (TB, K) or null
  void* plane0;
  void* plane1;
};

template <int LPT, int COPIES, int PLANE>
struct Regs {
  int S[COPIES][LPT], I1[COPIES][LPT], D1[COPIES][LPT], I2[COPIES][LPT],
      D2[COPIES][LPT];
  int R[PLANE ? LPT : 1];  // x6's match run band
  int Q[LPT], T[LPT];      // the stream values at the thread's lanes
};

// the stream rows' skewed layout: position x at x + x / 32 (threads
// LPT apart read distinct banks) for even LPT; plain for odd LPT
template <int LPT>
__host__ __device__ __forceinline__ int skew(int x) {
  return LPT % 2 == 0 ? x + (x >> 5) : x;
}

// NB bytes from 32-bit words (byte o in word o / 4) to dst, in the
// widest aligned pieces NB allows (dst is NB-aligned up to 16)
template <int NB>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint32_t (&w)[(NB + 3) / 4]) {
  constexpr int CH = NB % 16 == 0 ? 16 : NB % 8 == 0 ? 8 : NB % 4 == 0 ? 4 : NB % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int o = 0; o < NB; o += CH) {
    if constexpr (CH == 16)
      *reinterpret_cast<uint4*>(dst + o) = make_uint4(w[o / 4], w[o / 4 + 1], w[o / 4 + 2], w[o / 4 + 3]);
    else if constexpr (CH == 8)
      *reinterpret_cast<uint2*>(dst + o) = make_uint2(w[o / 4], w[o / 4 + 1]);
    else if constexpr (CH == 4)
      *reinterpret_cast<uint32_t*>(dst + o) = w[o / 4];
    else if constexpr (CH == 2)
      *reinterpret_cast<uint16_t*>(dst + o) = (uint16_t)(w[o / 4] >> (8 * (o % 4)));
    else
      dst[o] = (uint8_t)(w[o / 4] >> (8 * (o % 4)));
  }
}

// LPT elements of E bytes (the low bytes of v) to dst
template <int LPT, int E>
__device__ __forceinline__ void store_lanes(void* dst, const int (&v)[LPT]) {
  constexpr int NB = LPT * E;
  uint32_t w[(NB + 3) / 4];
#pragma unroll
  for (int k = 0; k < (NB + 3) / 4; ++k) w[k] = 0;
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    const uint32_t x = E == 4 ? (uint32_t)v[r] : ((uint32_t)v[r] & ((1u << (8 * E)) - 1));
    w[(r * E) / 4] |= x << (8 * ((r * E) % 4));
  }
  store_bytes<NB>(static_cast<uint8_t*>(dst), w);
}

// LPT int32 from src, in the widest aligned vector loads
template <int LPT>
__device__ __forceinline__ void load_lanes(const int* src, int (&v)[LPT]) {
  constexpr int CH = LPT % 4 == 0 ? 4 : LPT % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int r = 0; r < LPT; r += CH) {
    if constexpr (CH == 4) {
      const int4 x = *reinterpret_cast<const int4*>(src + r);
      v[r] = x.x; v[r + 1] = x.y; v[r + 2] = x.z; v[r + 3] = x.w;
    } else if constexpr (CH == 2) {
      const int2 x = *reinterpret_cast<const int2*>(src + r);
      v[r] = x.x; v[r + 1] = x.y;
    } else {
      v[r] = src[r];
    }
  }
}

// halo: [2 sides][2 buffers][COPIES][warps + 2] slots of 4 ints. Side 0
// (L): a warp's last lane's S, I1, I2, written after odd steps; side 1
// (R): its first lane's S, D1, D2, written after even steps. Warp w
// writes slot w + 1; slots 0 and warps + 1 hold INF (beyond the band's
// ends), so the neighbours' slots w and w + 2 need no test. With hb =
// (d >> 1) & 1, a step writes buffer hb of its side and reads buffer
// hb ^ 1 of L and buffer (d odd ? hb : hb ^ 1) of R: the last write
// before d.
constexpr int HALO_SLOTS = REG_WARPS + 2;

template <int COPIES>
__device__ __forceinline__ int4* halo_at(int* halo, int side, int buf, int cp, int slot) {
  return reinterpret_cast<int4*>(halo) + ((side * 2 + buf) * COPIES + cp) * HALO_SLOTS + slot;
}

// one step at anti-diagonal d of lane parity DP (a constant after
// unrolling), every copy; then the halo of the side that moved
template <int LPT, int COPIES, int PLANE>
__device__ __forceinline__ void reg_step(Regs<LPT, COPIES, PLANE>& st, int* halo,
                                         const int DP, int d, int q2, int c0,
                                         int lane, int warp, uint8_t* prow0,
                                         uint8_t* prow1) {
  const int tpar = threadIdx.x & 1;  // c0's parity when LPT is odd
  const int lo = lane_lo(d, q2), hi = lane_hi(d, q2);
  const int hb = (d >> 1) & 1;
  // register r's lane lies in [lo, hi] iff rlo <= r <= rhi, and has a
  // diagonal iff dlo <= r <= dhi
  const int rlo = lo - c0, rhi = hi - c0, dlo = 2 - d - c0, dhi = d - 2 - c0;
  // a register moves iff its lane's parity is d's: c0 + r
  auto moves = [&](int r) {
    return LPT % 2 == 0 ? ((r & 1) == DP) : (((tpar + r) & 1) == DP);
  };
  // which neighbours a step needs: the left one of register 0 (an even
  // lane when LPT is even) and the right one of register LPT - 1
  const bool need_left = PLANE || LPT % 2 != 0 || DP == 0;
  const bool need_right = PLANE || LPT % 2 != 0 || DP == 1;
#pragma unroll
  for (int cp = 0; cp < COPIES; ++cp) {
    int(&S)[LPT] = st.S[cp];
    int4 left = make_int4(INF, INF, INF, 0), right = left;
    if (need_left) {
      // a warp's first lane (even) takes the previous warp's last lane:
      // at even d as it was after the last odd step, at odd d (x6's idle
      // entry) as it was before this one
      const int4 h = *halo_at<COPIES>(halo, 0, hb ^ 1, cp, warp);
      left.x = __shfl_up_sync(FULL, S[LPT - 1], 1);
      left.y = __shfl_up_sync(FULL, st.I1[cp][LPT - 1], 1);
      left.z = __shfl_up_sync(FULL, st.I2[cp][LPT - 1], 1);
      if (lane == 0) left = h;
    }
    if (need_right) {
      const int4 h = *halo_at<COPIES>(halo, 1, DP ? hb : hb ^ 1, cp, warp + 2);
      right.x = __shfl_down_sync(FULL, S[0], 1);
      right.y = __shfl_down_sync(FULL, st.D1[cp][0], 1);
      right.z = __shfl_down_sync(FULL, st.D2[cp][0], 1);
      if (lane == 31) right = h;
    }
    // register r's recurrence from the values before the step
    auto terms_at = [&](int r, bool diag_ok) {
      return step_terms(
          S[r], r > 0 ? S[r - 1] : left.x, r > 0 ? st.I1[cp][r - 1] : left.y,
          r > 0 ? st.I2[cp][r - 1] : left.z, r < LPT - 1 ? S[r + 1] : right.x,
          r < LPT - 1 ? st.D1[cp][r + 1] : right.y, r < LPT - 1 ? st.D2[cp][r + 1] : right.z,
          st.Q[r], st.T[r], diag_ok);
    };
    auto commit = [&](int r, const Terms& t) {
      S[r] = t.sn;
      st.I1[cp][r] = t.i1n;
      st.D1[cp][r] = t.d1n;
      st.I2[cp][r] = t.i2n;
      st.D2[cp][r] = t.d2n;
    };
    if constexpr (PLANE != 0) {
      // every lane's entry from the pre-step values, then the commit
      Terms t[LPT];
      int ent[LPT], nR[LPT];
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        t[r] = terms_at(r, r >= dlo && r <= dhi);
        ent[r] = plane_entry(t[r], st.R[r], nR[r]);
      }
      if constexpr (PLANE == 1) {
        store_lanes<LPT, 1>(prow0, ent);
        int run[LPT];
#pragma unroll
        for (int r = 0; r < LPT; ++r) run[r] = ent[r] >> 8;
        store_lanes<LPT, 1>(prow1, run);
      } else {
        store_lanes<LPT, PLANE == 2 ? 2 : 4>(prow0, ent);
      }
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        if (moves(r) && r >= rlo && r <= rhi) {
          commit(r, t[r]);
          st.R[r] = nR[r];
        }
      }
    } else if (__all_sync(FULL, rlo <= 0 && rhi >= LPT - 1 && dlo <= 0 && dhi >= LPT - 1)) {
      // every lane of the warp moves (parity aside) and has a diagonal:
      // the moving registers read only idle ones, so they commit in place
#pragma unroll
      for (int r = 0; r < LPT; ++r)
        if (moves(r)) commit(r, terms_at(r, true));
    } else if (__any_sync(FULL, rhi >= 0 && rlo <= LPT - 1)) {
      // some lane of the warp moves: each register by predicate
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        if (LPT % 2 == 0 && !moves(r)) continue;
        const Terms t = terms_at(r, r >= dlo && r <= dhi);
        if (moves(r) && r >= rlo && r <= rhi) commit(r, t);
      }
    }
    if (DP == 1 && lane == 31)
      *halo_at<COPIES>(halo, 0, hb, cp, warp + 1) =
          make_int4(S[LPT - 1], st.I1[cp][LPT - 1], st.I2[cp][LPT - 1], 0);
    if (DP == 0 && lane == 0)
      *halo_at<COPIES>(halo, 1, hb, cp, warp + 1) = make_int4(S[0], st.D1[cp][0], st.D2[cp][0], 0);
  }
}

// the S band a launch hands out: copy 0's, or v4's sum of both copies
template <int LPT, int COPIES, int PLANE>
__device__ __forceinline__ void out_band(const Regs<LPT, COPIES, PLANE>& st, int (&o)[LPT]) {
#pragma unroll
  for (int r = 0; r < LPT; ++r) o[r] = COPIES == 2 ? wadd(st.S[0][r], st.S[1][r]) : st.S[0][r];
}

// the launch's steps from a start parity P0 fixed at compile time: the
// step of unrolled position u has lane parity (P0 + u) & 1
template <int LPT, int UNROLL, int COPIES, int PLANE, int P0>
__device__ __forceinline__ void reg_sweep(Regs<LPT, COPIES, PLANE>& st, const StepArgs& a,
                                          int d_first, int* halo, const int* qrow,
                                          const int* trow, int pq, int pt, int L) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = tid * LPT;
  const size_t row = (size_t)blockIdx.x * a.K + c0;
  const size_t pstride = (size_t)a.TB * a.K;
  constexpr int PE = PLANE == 1 ? 1 : PLANE == 2 ? 2 : 4;  // plane bytes an entry
  uint8_t* prow0 = PLANE ? static_cast<uint8_t*>(a.plane0) + row * PE : nullptr;
  uint8_t* prow1 = PLANE == 1 ? static_cast<uint8_t*>(a.plane1) + row : nullptr;
  int d = d_first;
  for (int g0 = 0; g0 < a.n_steps; g0 += a.chunk) {
    for (int g = 0; g < a.chunk; g += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        reg_step<LPT, COPIES, PLANE>(st, halo, (P0 + u) & 1, d, a.q2, c0, lane, warp,
                                     prow0, prow1);
        if (PLANE) {
          prow0 += pstride * PE;
          if (PLANE == 1) prow1 += pstride;
        }
        // the stream values of the next step: one lane in, one out
        pq = pq == 0 ? L - 1 : pq - 1;
        pt = pt == L - 1 ? 0 : pt + 1;
#pragma unroll
        for (int r = LPT - 1; r > 0; --r) st.Q[r] = st.Q[r - 1];
        st.Q[0] = qrow[skew<LPT>(pq + c0)];
#pragma unroll
        for (int r = 0; r < LPT - 1; ++r) st.T[r] = st.T[r + 1];
        st.T[LPT - 1] = trow[skew<LPT>(pt + c0 + LPT - 1)];
        __syncthreads();
        ++d;
      }
    }
    if (a.sout_every || a.dummy != nullptr) {
      int o[LPT];
      out_band(st, o);
      if (a.sout_every) store_lanes<LPT, 4>(a.sout + row, o);
      if (a.dummy != nullptr) store_lanes<LPT, 1>(a.dummy + row, o);
    }
  }
}

template <int LPT, int UNROLL, int COPIES, int PLANE>
// one block an SM at most (TB problems on TB SMs): every register a thread may take
__global__ void __launch_bounds__(REG_THREADS, 1) step_regs_kernel(const StepArgs a) {
  extern __shared__ __align__(16) int sm[];
  const int L = a.W + a.K;
  const int LS = (skew<LPT>(2 * L - 1) + 4) & ~3;
  int* halo = sm;  // [2][2][COPIES][HALO_SLOTS][4]
  int* qrow = halo + 2 * 2 * COPIES * HALO_SLOTS * 4;  // the doubled rows, skewed
  int* trow = qrow + LS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t prob = (size_t)blockIdx.x * a.K;
  const int c0 = tid * LPT;
  const size_t bstride = (size_t)a.TB * a.K;

  for (int x = tid; x < L; x += REG_THREADS) {
    const int qv = x < a.W ? a.fill : a.qb0[prob + x - a.W];
    const int tv = x < a.K ? a.tb0[prob + x] : a.fill;
    qrow[skew<LPT>(x)] = qv;
    qrow[skew<LPT>(x + L)] = qv;
    trow[skew<LPT>(x)] = tv;
    trow[skew<LPT>(x + L)] = tv;
  }
  Regs<LPT, COPIES, PLANE> st;
  if (a.n0 == 0) {
    int s[LPT];
    load_lanes<LPT>(a.s_in + prob + c0, s);
#pragma unroll
    for (int cp = 0; cp < COPIES; ++cp)
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        st.S[cp][r] = wadd(s[r], cp);
        st.I1[cp][r] = st.D1[cp][r] = st.I2[cp][r] = st.D2[cp][r] = INF;
      }
  } else {  // COPIES == 1
    load_lanes<LPT>(a.state + prob + c0, st.S[0]);
    load_lanes<LPT>(a.state + bstride + prob + c0, st.I1[0]);
    load_lanes<LPT>(a.state + 2 * bstride + prob + c0, st.D1[0]);
    load_lanes<LPT>(a.state + 3 * bstride + prob + c0, st.I2[0]);
    load_lanes<LPT>(a.state + 4 * bstride + prob + c0, st.D2[0]);
  }
#pragma unroll
  for (int r = 0; r < (PLANE ? LPT : 1); ++r) st.R[r] = 0;  // a plane sweep starts at 0
  // every halo buffer from the start state; the end slots INF
#pragma unroll
  for (int cp = 0; cp < COPIES; ++cp)
#pragma unroll
    for (int buf = 0; buf < 2; ++buf) {
      if (lane == 31)
        *halo_at<COPIES>(halo, 0, buf, cp, warp + 1) =
            make_int4(st.S[cp][LPT - 1], st.I1[cp][LPT - 1], st.I2[cp][LPT - 1], 0);
      if (lane == 0)
        *halo_at<COPIES>(halo, 1, buf, cp, warp + 1) =
            make_int4(st.S[cp][0], st.D1[cp][0], st.D2[cp][0], 0);
      if (tid < 2)
        for (int side = 0; side < 2; ++side)
          *halo_at<COPIES>(halo, side, buf, cp, tid * (HALO_SLOTS - 1)) =
              make_int4(INF, INF, INF, 0);
    }
  const int base = a.base != nullptr ? *a.base : 0;
  __syncthreads();

  // stream offsets at step n0, after its n0 + 1 rotations
  int pq = (a.W - (a.n0 + 1)) % L;
  if (pq < 0) pq += L;
  const int pt = (a.n0 + 1) % L;
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    st.Q[r] = qrow[skew<LPT>(pq + c0 + r)];
    st.T[r] = trow[skew<LPT>(pt + c0 + r)];
  }
  const int d_first = base + a.n0 + 2;
  if (d_first & 1)
    reg_sweep<LPT, UNROLL, COPIES, PLANE, 1>(st, a, d_first, halo, qrow, trow, pq, pt, L);
  else
    reg_sweep<LPT, UNROLL, COPIES, PLANE, 0>(st, a, d_first, halo, qrow, trow, pq, pt, L);

  if (a.state != nullptr) {
    store_lanes<LPT, 4>(a.state + prob + c0, st.S[0]);
    store_lanes<LPT, 4>(a.state + bstride + prob + c0, st.I1[0]);
    store_lanes<LPT, 4>(a.state + 2 * bstride + prob + c0, st.D1[0]);
    store_lanes<LPT, 4>(a.state + 3 * bstride + prob + c0, st.I2[0]);
    store_lanes<LPT, 4>(a.state + 4 * bstride + prob + c0, st.D2[0]);
  }
  if (a.sout_last) {
    int o[LPT];
    out_band(st, o);
    store_lanes<LPT, 4>(a.sout + prob + c0, o);
  }
}

template <int LPT, int UNROLL, int COPIES, int PLANE>
int launch_regs(const StepArgs& a, cudaStream_t st) {
  const int L = a.W + a.K;
  const int smem = 4 * (2 * ((skew<LPT>(2 * L - 1) + 4) & ~3) + 2 * 2 * COPIES * HALO_SLOTS * 4);
  auto kernel = step_regs_kernel<LPT, UNROLL, COPIES, PLANE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<a.TB, REG_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// the variants a K takes: planes only at unroll 2 with one copy
template <int LPT>
int launch_regs_variant(const StepArgs& a, int unroll, int copies, int plane,
                        cudaStream_t st) {
  if (plane != 0) {
    if (unroll != 2 || copies != 1) return (int)cudaErrorInvalidValue;
    switch (plane) {
      case 1: return launch_regs<LPT, 2, 1, 1>(a, st);
      case 2: return launch_regs<LPT, 2, 1, 2>(a, st);
      case 3: return launch_regs<LPT, 2, 1, 3>(a, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (copies == 2 && unroll == 2) return launch_regs<LPT, 2, 2, 0>(a, st);
  if (copies != 1) return (int)cudaErrorInvalidValue;
  switch (unroll) {
    case 2: return launch_regs<LPT, 2, 1, 0>(a, st);
    case 4: return launch_regs<LPT, 4, 1, 0>(a, st);
    case 8: return launch_regs<LPT, 8, 1, 0>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x4 v0: qb0, tb0, s_in, sout (TB, K) int32; K <= 2048
int allwave_probe_step_smem(const void* qb0, const void* tb0, const void* s_in,
                            int TB, int K, int W, int fill, int q2, int n_steps,
                            void* sout, void* stream) {
  if (TB <= 0 || K <= 0 || K > MAX_SMEM_K || W < 0 || n_steps <= 0)
    return (int)cudaErrorInvalidValue;
  const int KH = (K + 1) / 2;
  const int threads = (KH + 31) / 32 * 32;
  const int smem = 4 * (2 * (KH + 2) * BANDS + 4 * (W + K));
  cudaFuncSetAttribute(step_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  step_smem_kernel<<<TB, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qb0), static_cast<const int*>(tb0),
      static_cast<const int*>(s_in), K, W, fill, q2, n_steps, static_cast<int*>(sout));
  return (int)cudaGetLastError();
}

// x4 v1-v4, x5, x6: K = 256 * LPT with LPT in {1, 2, 4, 6, 8}; qb0, tb0,
// s_in (TB, K) int32; steps n0 .. n0 + n_steps - 1 in chunks of `chunk`
// (a multiple of the unroll); state (5, TB, K) int32 or null (needed
// when n0 > 0; one copy); base one int32 or null; sout (TB, K) int32,
// written after every chunk (sout_every) and/or the last (sout_last);
// dummy (TB, K) uint8 or null, after every chunk; plane_mode 1: two
// (n_steps, TB, K) uint8 planes, 2: one uint16, 3: one int32 (from
// n0 == 0, unroll 2, one copy).
int allwave_probe_step_regs(const void* qb0, const void* tb0, const void* s_in,
                            int TB, int K, int W, int fill, int q2, int n0,
                            int n_steps, int chunk, int unroll, int copies,
                            void* state, const void* base, void* sout,
                            int sout_every, int sout_last, void* dummy,
                            int plane_mode, void* plane0, void* plane1,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (TB <= 0 || W < 0 || n_steps <= 0 || unroll <= 0 || chunk <= 0 ||
      n_steps % chunk || chunk % unroll || n0 < 0 || (n0 > 0 && state == nullptr) ||
      (state != nullptr && copies != 1) || (plane_mode != 0 && n0 != 0) ||
      plane_mode < 0 || plane_mode > 3 || (plane_mode != 0 && plane0 == nullptr) ||
      (plane_mode == 1 && plane1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{static_cast<const int*>(qb0), static_cast<const int*>(tb0),
                   static_cast<const int*>(s_in), TB, K, W, fill, q2, n0, n_steps, chunk,
                   static_cast<int*>(state), static_cast<const int*>(base),
                   static_cast<int*>(sout), sout_every, sout_last,
                   static_cast<uint8_t*>(dummy), plane0, plane1};
  switch (K) {
    case 256: return launch_regs_variant<1>(a, unroll, copies, plane_mode, st);
    case 512: return launch_regs_variant<2>(a, unroll, copies, plane_mode, st);
    case 1024: return launch_regs_variant<4>(a, unroll, copies, plane_mode, st);
    case 1536: return launch_regs_variant<6>(a, unroll, copies, plane_mode, st);
    case 2048: return launch_regs_variant<8>(a, unroll, copies, plane_mode, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
