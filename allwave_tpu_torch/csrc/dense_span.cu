// One span of the banded Gotoh DP from a checkpointed band state: the
// step of the segmented (checkpoint-replay) engine's sweep and replay.
//
// Replaces: allwave_tpu/wfa/pallas_span.py `_span_call` (kernel
// `_span_kernel`, whose step body is pallas_dense.py `run_dp_chunk`),
// reached through `dense_span_pallas`, `dense_span_pallas_pre` and the
// narrow-replay `dense_span_pallas_sub`; and with it the parity-
// compressed twin pallas_span_c2.py `dense_span_pallas_c2`, which
// computes the same function in another TPU layout. Its plain twin is
// allwave_tpu_torch/wfa/segmented.py `dense_span_ref`.
//
// What bounds it on an H100: a span is a chain of n_steps dependent
// anti-diagonal steps per pair, each a few dozen integer ops per band
// lane and a barrier. The long path runs few pairs (12 at 100 kb) on
// wide bands (the sweep's K up to 24576, the replay's window k_sub =
// 4480), so the time is the chain of steps, each as long as the lanes
// one SM walks plus its barrier; the replay adds a plane entry (19 more
// issue slots) and one 2-byte store per lane and step.
//
// Two designs, both a thread-block cluster of G blocks a pair, chosen
// in one place (`choose` below, exported as allwave_dense_span_design).
// Block r owns the window's lanes [r Lb, min((r+1) Lb, W)), Lb even, so
// only the last block is short; G <= 16 where the card holds every
// pair's cluster at once (above 8 a cluster size is non-portable), else
// G <= 8. G = 1 is an ordinary block with a block barrier. One cluster
// barrier a step (`sweep_barrier`) orders each step's shared-memory
// writes before the next step's reads, the neighbour blocks' reads over
// distributed shared memory included, and those reads before the next
// step's writes; its release fence is restricted to the block's shared
// memory, the only memory a step writes that another block reads, so a
// block only reads a neighbour's memory and never stores into it.
//
// * The sweep (no planes): `dense_sweep_cluster_kernel`, at least 1024
//   lanes a block. A block keeps its lanes' five bands parity-packed in
//   shared memory, [band][even lanes | odd lanes], updated in place:
//   step d moves only the lanes of d's parity, which read the other
//   parity's S, I1, I2 at k - 1 and S, D1, D2 at k + 1 (written at
//   d - 1) and their own S (from d - 2). Writing no plane, it computes
//   no lane of the wrong parity and copies nothing. A block's edge lanes
//   read the neighbour block's edge lane over distributed shared memory.
// * The replay (planes): `dense_replay_cluster_kernel`, warps of 32
//   threads each holding LPT adjacent lanes of S, I1, D1, I2, D2 and the
//   run band in registers, at most RP_WARPS warps a block (one a warp
//   scheduler) before a band spreads over more blocks. Every lane writes
//   a plane entry every step, the idle parity's too, from the values its
//   neighbours held before this step: new values go to temporaries and
//   are committed after the entries. Neighbours come by warp shuffles;
//   at warp edges from a double-buffered halo in shared memory (a warp's
//   last lane's S, I1, I2 and its first lane's S, D1, D2 after each
//   step), at block edges from the neighbour block's halo over
//   distributed shared memory. A lane's k parity is its register's (k0
//   even offsets aside, the block's first k is the same parity for every
//   thread), so which registers may move is compile-time in each of two
//   step bodies, one per parity. Entries go out LPT at a time (8- or
//   16-byte stores) where W keeps them aligned.
//
// Both read the bases as two tables of the clamped bytes the plain
// version reads (the XLA span's shift registers: q[v-1] through the
// reversed query, t[h-1]), indexed by v and by h, staged in shared memory
// for each stretch of SW_STRETCH steps, so every plane byte -- reachable
// or not -- equals the plain version's. Both take the state from a
// checkpoint slice, optionally at a per-pair column offset c_lo into a
// wider band (the narrow replay: origin k0 + c_lo, INF inflow at the
// window's edges), and write the state out straight to its slot (the
// next checkpoint, in the sweep). Offsets into states and planes are
// 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int SW_PORTABLE_G = 8;  // the portable cluster size
constexpr int SW_MAX_G = 16;      // the largest (non-portable) cluster
constexpr int SW_MIN_LB = 1024;   // sweep: lanes a block before a band spreads
constexpr int SW_STRETCH = 4096;  // steps one staging of the base tables covers
constexpr int RP_WARPS = 4;       // replay: warps a block before a band spreads
constexpr int RP_MAX_WARPS = 12;  // replay: the most warps a block (168 registers)

struct Pen {
  int x, o1e1, e1, o2e2, e2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(a / 2) of a compile-time constant
__host__ __device__ constexpr int fl2(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

// The step barrier across a cluster: each thread's release fence
// restricted to its own block's shared memory (MEMBAR.ALL.CTA, not the
// GPU-wide MEMBAR that cluster.sync()'s release arrive issues), a relaxed
// arrive and an acquiring wait. It orders every shared-memory write and
// read of the step before every block's next step, its neighbours'
// reads over distributed shared memory included.
__device__ __forceinline__ void sweep_barrier() {
  asm volatile(
      "fence.release.sync_restrict::shared::cta.cluster;\n"
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// bytes of each base table: every v (and h) a block of Lb lanes reads
// over SW_STRETCH steps
__host__ __device__ constexpr int sweep_table_bytes(int Lb) {
  return ((SW_STRETCH + Lb) / 2 + 2 + 15) / 16 * 16;
}

__host__ __device__ constexpr int sweep_smem_bytes(int Lb) {
  return 20 * Lb + 2 * sweep_table_bytes(Lb);
}

// the replay block's halo ([2 buffers][warps][6] int32) and base tables
__host__ __device__ constexpr int replay_smem_bytes(int Lb, int lpt) {
  return 48 * (Lb / (32 * lpt)) + 2 * sweep_table_bytes(Lb);
}

// the tables qt[i] and tt[i]: the bytes the plain version reads at
// v = vmin + i and h = hmin + i, for every lane of a block of Lb lanes
// whose first lane has k = kb and every step of the stretch from d_a
__device__ __forceinline__ void stage_tables(uint8_t* qt, uint8_t* tt, int tbl,
                                             const uint8_t* q, const uint8_t* t,
                                             int qlen, int l_pad, int kb, int Lb,
                                             int d_a, int& vmin, int& hmin) {
  vmin = (d_a - kb - (Lb - 1)) >> 1;
  hmin = (d_a + kb) >> 1;
  for (int i = threadIdx.x; i < tbl; i += blockDim.x) {
    const int qi = clampi(qlen - (vmin + i), 0, l_pad - 1);
    qt[i] = q[clampi(qlen - 1 - qi, 0, l_pad - 1)];
    tt[i] = t[clampi(hmin + i - 1, 0, l_pad - 1)];
  }
}

// ---------------------------------------------------------------------
// the sweep: parity-packed bands in shared memory

template <bool TWO_PIECE>
__global__ void __launch_bounds__(1024, 1) dense_sweep_cluster_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ c_lo, int l_pad, int K, int W, int d_lo,
    int n_steps, int G, int Lb, Pen pen, const int* __restrict__ state_in,
    long long in_band_stride, int* __restrict__ state_out,
    long long out_band_stride) {
  extern __shared__ __align__(16) int bands[];  // [band][half][Lb / 2]
  cg::cluster_group cluster = cg::this_cluster();
  const int r = G > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;

  // band geometry of the full band K (dense.py _band_geometry), then the
  // window [col0, col0 + W) of it, then this block's lanes of it
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  int k0 = min(0, k_end) - ((K - 1 - abs_kend) >> 1);
  k0 -= (k0 & 1);
  const int col0 = c_lo == nullptr ? 0 : clampi(c_lo[b], 0, K - W);
  const int c_first = r * Lb;
  const int n_r = min(Lb, W - c_first);  // lanes of this block, >= 1
  const int kb = k0 + col0 + c_first;    // k of lane j is kb + j
  const int Lh = Lb >> 1;

  // lane j's bands at [band][j & 1][j >> 1]
  uint8_t* qt = reinterpret_cast<uint8_t*>(bands + 10 * Lh);
  const int tbl = sweep_table_bytes(Lb);
  uint8_t* tt = qt + tbl;
#define SBAND(band, half) (bands + ((band) * 2 + (half)) * Lh)

  const long long src0 = (long long)b * K + col0 + c_first;
  for (int j = tid; j < n_r; j += nt)
    for (int band = 0; band < 5; ++band)
      SBAND(band, j & 1)[j >> 1] = state_in[band * in_band_stride + src0 + j];
  // the neighbours' edge lanes, read over distributed shared memory: the
  // left block's last lane (j = Lb - 1: odd, the last of its half 1) and
  // the right block's first (j = 0); INF past the window's edges
  const int* left = r > 0 ? cluster.map_shared_rank(bands, r - 1) + (Lh - 1) : nullptr;
  const int* right = r < G - 1 ? cluster.map_shared_rank(bands, r + 1) : nullptr;

  int vmin = 0, hmin = 0;
  stage_tables(qt, tt, tbl, q, t, qlen, l_pad, kb, Lb, d_lo + 1, vmin, hmin);
  // every block of the cluster has started and loaded its lanes and
  // tables before any neighbour reads them
  if (G > 1) cluster.sync(); else __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int d = d_lo + 1 + s;
    if (s > 0 && s % SW_STRETCH == 0) {
      // the last step's barrier: no thread reads the old tables
      stage_tables(qt, tt, tbl, q, t, qlen, l_pad, kb, Lb, d, vmin, hmin);
      __syncthreads();
    }
    // lanes of d's parity move: j = 2 i + p, from the other half's
    // lanes i + p - 1 (k - 1) and i + p (k + 1)
    const int p = (d - kb) & 1;
    const int cnt = (n_r - p + 1) >> 1;
    // inside the matrix: |k| <= d, k >= d - 2 qlen, k <= 2 tlen - d
    const int kmin = max(-d, d - 2 * qlen), kmax = min(d, 2 * tlen - d);
    const int i_lo = max(0, (kmin - kb - p + 1) >> 1);
    const int i_hi = min(cnt - 1, (kmax - kb - p) >> 1);
    const int vb = (d - kb - p) >> 1, hb = (d + kb + p) >> 1;
    const int* Sq = SBAND(0, p ^ 1);
    const int* I1q = SBAND(1, p ^ 1);
    const int* D1q = SBAND(2, p ^ 1);
    const int* I2q = SBAND(3, p ^ 1);
    const int* D2q = SBAND(4, p ^ 1);
    int* Sp = SBAND(0, p);
    int* I1p = SBAND(1, p);
    int* D1p = SBAND(2, p);
    int* I2p = SBAND(3, p);
    int* D2p = SBAND(4, p);
    const uint8_t* qv = qt + (vb - vmin);  // qv[-i]: the byte at v = vb - i
    const uint8_t* th = tt + (hb - hmin);  // th[i]: the byte at h = hb + i

    for (int i = i_lo + tid; i <= i_hi; i += nt) {
      const int j = 2 * i + p;
      int s_km1 = AW_INF, i1l = AW_INF, i2l = AW_INF;
      if (j > 0) {
        s_km1 = Sq[i + p - 1];
        i1l = I1q[i + p - 1];
        if (TWO_PIECE) i2l = I2q[i + p - 1];
      } else if (left != nullptr) {
        s_km1 = left[Lh];  // (band 0, half 1)
        i1l = left[3 * Lh];
        if (TWO_PIECE) i2l = left[7 * Lh];
      }
      int s_kp1 = AW_INF, d1r = AW_INF, d2r = AW_INF;
      if (j + 1 < n_r) {
        s_kp1 = Sq[i + p];
        d1r = D1q[i + p];
        if (TWO_PIECE) d2r = D2q[i + p];
      } else if (right != nullptr) {
        s_kp1 = right[0];  // (band 0, half 0)
        d1r = right[4 * Lh];
        if (TWO_PIECE) d2r = right[8 * Lh];
      }
      const int i1_new = min(s_km1 + pen.o1e1, i1l + pen.e1);
      const int d1_new = min(s_kp1 + pen.o1e1, d1r + pen.e1);
      int best_gap = min(i1_new, d1_new);
      int i2_new, d2_new;
      if (TWO_PIECE) {
        i2_new = min(s_km1 + pen.o2e2, i2l + pen.e2);
        d2_new = min(s_kp1 + pen.o2e2, d2r + pen.e2);
        best_gap = min(best_gap, min(i2_new, d2_new));
      } else {
        i2_new = I2p[i];
        d2_new = D2p[i];
      }
      const int v = vb - i, h = hb + i;
      const bool is_match = qv[-i] == th[i];
      const int diag = v > 0 && h > 0 ? Sp[i] + (is_match ? 0 : pen.x) : AW_INF;
      Sp[i] = min(min(diag, best_gap), AW_INF);
      I1p[i] = min(i1_new, AW_INF);
      D1p[i] = min(d1_new, AW_INF);
      I2p[i] = min(i2_new, AW_INF);
      D2p[i] = min(d2_new, AW_INF);
    }
    // this step's writes before the next step's reads (the neighbours'
    // included) and its reads before the next step's writes; after the
    // last step, no block exits while a neighbour may still read it
    if (G > 1) sweep_barrier(); else __syncthreads();
  }

  const long long dst0 = (long long)b * W + c_first;
  for (int j = tid; j < n_r; j += nt)
    for (int band = 0; band < 5; ++band)
      state_out[band * out_band_stride + dst0 + j] = SBAND(band, j & 1)[j >> 1];
#undef SBAND
}

// n_steps barriers and nothing else, in the sweep's launch shape: what
// the sweep's barrier costs a step (full_fence 0), or cooperative
// groups' cluster.sync() (full_fence 1)
__global__ void __launch_bounds__(1024, 1) sweep_barrier_kernel(int G, int n_steps,
                                                                int full_fence,
                                                                int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  int s = 0;
  for (; s < n_steps; ++s) {
    if (G == 1) {
      __syncthreads();
    } else if (full_fence) {
      cluster.sync();
    } else {
      sweep_barrier();
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// ---------------------------------------------------------------------
// the replay: band lanes in registers, every plane entry

// a thread's LPT plane entries, as words w[i / 2] (entry i in the low
// half when i is even), at pd: LPT at a time (8 or 16 bytes) where W
// keeps them aligned, else 32-bit words (W even) or 16-bit entries;
// entries i < nin only
template <int LPT>
__device__ __forceinline__ void store_entries(uint16_t* pd, const uint32_t (&w)[LPT / 2],
                                              int nin, int W) {
  if (W % LPT == 0) {
    if (nin >= LPT) {
      if constexpr (LPT == 8)
        *reinterpret_cast<uint4*>(pd) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(pd) = make_uint2(w[0], w[1]);
    }
  } else if ((W & 1) == 0) {
#pragma unroll
    for (int j = 0; j < LPT; j += 2)
      if (j + 2 <= nin) *reinterpret_cast<uint32_t*>(pd + j) = w[j / 2];
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (i < nin) pd[i] = (uint16_t)(w[i / 2] >> (16 * (i & 1)));
  }
}

// One step of a thread's LPT register lanes, k = kt + i, at anti-
// diagonal d with x = d - kt and y = d + kt, whose parity is M: the
// registers i of parity M move. sl .. d2r: the neighbours at k - 1 of
// register 0 and at k + 1 of register LPT - 1, as they were after the
// step before. qp / tp: the base tables at v = x >> 1 and h = y >> 1.
// Every register's plane entry goes to pd; registers i >= nin lie past
// the window, stay INF and store nothing.
template <int M, int LPT, bool TWO>
__device__ __forceinline__ void replay_step(
    int (&S)[LPT], int (&I1)[LPT], int (&D1)[LPT], int (&I2)[TWO ? LPT : 1],
    int (&D2)[TWO ? LPT : 1], int (&R)[LPT], int x, int y, int q2, int t2, int nin,
    const uint8_t* qp, const uint8_t* tp, int sl, int i1l, int i2l, int sr, int d1r,
    int d2r, const Pen& pen, uint16_t* pd, int W) {
  // register i moves iff its parity is M and lo <= i <= hi: |k| <= d <=
  // min(k + 2 qlen, 2 tlen - k), inside the window
  const int lo = max(-y, x - q2);
  const int hi = min(min(x, t2 - y), nin - 1);
  // the diagonal term exists iff v > 0 and h > 0: |k| + 2 <= d
  const int dlo = 2 - y, dhi = x - 2;
  int nS[LPT], nI1[LPT], nD1[LPT], nI2[TWO ? LPT : 1], nD2[TWO ? LPT : 1], nR[LPT];
  uint32_t w[LPT / 2];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int s_km1 = i > 0 ? S[i - 1] : sl;
    const int s_kp1 = i < LPT - 1 ? S[i + 1] : sr;
    const int i1e = (i > 0 ? I1[i - 1] : i1l) + pen.e1;
    const int i1o = s_km1 + pen.o1e1;
    const int i1n = min(i1o, i1e);
    const int d1e = (i < LPT - 1 ? D1[i + 1] : d1r) + pen.e1;
    const int d1o = s_kp1 + pen.o1e1;
    const int d1n = min(d1o, d1e);
    int i2n = AW_INF, d2n = AW_INF, i2x = 0, d2x = 0;
    if (TWO) {
      const int i2e = (i > 0 ? I2[i - 1] : i2l) + pen.e2;
      const int i2o = s_km1 + pen.o2e2;
      i2n = min(i2o, i2e);
      i2x = i2e <= i2o;  // a tie extends
      const int d2e = (i < LPT - 1 ? D2[i + 1] : d2r) + pen.e2;
      const int d2o = s_kp1 + pen.o2e2;
      d2n = min(d2o, d2e);
      d2x = d2e <= d2o;
    }
    // the best gap and its code, a tie to the earlier of I1 < I2 < D1 <
    // D2 (the plain version's last write wins in D2, D1, I2, I1 order)
    int best, code;
    if (TWO) {
      const int bi = min(i1n, i2n), bd = min(d1n, d2n);
      best = min(bi, bd);
      code = bi <= bd ? (i1n <= i2n ? 2 : 3) : (d1n <= d2n ? 4 : 5);
    } else {
      best = min(i1n, d1n);
      code = i1n <= d1n ? 2 : 4;
    }
    // v = (x - i) >> 1 and h = (y + i) >> 1, x and y of parity M
    const bool match = qp[fl2(M - i)] == tp[fl2(M + i)];
    const bool diag_ok = i >= dlo && i <= dhi;
    const int diag = diag_ok ? S[i] + (match ? 0 : pen.x) : AW_INF;
    const int sn = min(diag, best);
    // diag-mismatch over any gap, a gap over a diagonal match
    const int choice = diag <= best && diag_ok && !match ? 1 : (best == sn ? code : 0);
    const int packed = choice | ((i1e <= i1o) << 3) | ((d1e <= d1o) << 4) | (i2x << 5) |
                       (d2x << 6);
    const int newrun = choice == 0 ? min(R[i], 254) + 1 : 0;
    const uint32_t entry = (uint32_t)(packed | (newrun << 8));
    if (i & 1)
      w[i / 2] |= entry << 16;
    else
      w[i / 2] = entry;

    const bool active = (i & 1) == M && i >= lo && i <= hi;
    nS[i] = active ? min(sn, AW_INF) : S[i];
    nI1[i] = active ? min(i1n, AW_INF) : I1[i];
    nD1[i] = active ? min(d1n, AW_INF) : D1[i];
    if (TWO) {
      nI2[i] = active ? min(i2n, AW_INF) : I2[i];
      nD2[i] = active ? min(d2n, AW_INF) : D2[i];
    }
    nR[i] = active ? newrun : R[i];
  }
  store_entries<LPT>(pd, w, nin, W);
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    S[i] = nS[i];
    I1[i] = nI1[i];
    D1[i] = nD1[i];
    if (TWO) {
      I2[i] = nI2[i];
      D2[i] = nD2[i];
    }
    R[i] = nR[i];
  }
}

// Block r of pair blockIdx.x / G runs the window's lanes [r Lb, (r+1) Lb)
// with Lb = blockDim.x * LPT: thread j's registers are lanes j LPT ..
template <int LPT, bool TWO>
__global__ void __launch_bounds__(32 * RP_MAX_WARPS, 1) dense_replay_cluster_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ c_lo, int B, int l_pad, int K, int W, int d_lo,
    int n_steps, int G, Pen pen, const int* __restrict__ state_in,
    long long in_band_stride, int* __restrict__ state_out,
    long long out_band_stride, uint16_t* __restrict__ planes) {
  static_assert(LPT % 2 == 0, "a lane's parity of k is its register's");
  // [2 buffers][nw][6]: a warp's last lane (S, I1, I2), first (S, D1, D2)
  extern __shared__ __align__(16) int halo[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = G > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, nw = blockDim.x >> 5;
  const int Lb = blockDim.x * LPT;
  const int qlen = qlens[b], tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;

  // band geometry of the full band K (dense.py _band_geometry), then the
  // window [col0, col0 + W) of it, then this block's and thread's lanes
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  int k0 = min(0, k_end) - ((K - 1 - abs_kend) >> 1);
  k0 -= (k0 & 1);
  const int col0 = c_lo == nullptr ? 0 : clampi(c_lo[b], 0, K - W);
  const int kb = k0 + col0 + r * Lb;  // the block's first lane's k
  const int c0 = r * Lb + tid * LPT;  // the window column of register 0
  const int kt = kb + tid * LPT;      // its k: of kb's parity
  const int nin = W - c0;             // register i is in the window iff i < nin

  uint8_t* qt = reinterpret_cast<uint8_t*>(halo + 12 * nw);
  const int tbl = sweep_table_bytes(Lb);
  uint8_t* tt = qt + tbl;

  int S[LPT], I1[LPT], D1[LPT], I2[TWO ? LPT : 1], D2[TWO ? LPT : 1], R[LPT];
  const long long src = (long long)b * K + col0 + c0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool in = i < nin;
    S[i] = in ? state_in[src + i] : AW_INF;
    I1[i] = in ? state_in[in_band_stride + src + i] : AW_INF;
    D1[i] = in ? state_in[2 * in_band_stride + src + i] : AW_INF;
    if (TWO) {
      I2[i] = in ? state_in[3 * in_band_stride + src + i] : AW_INF;
      D2[i] = in ? state_in[4 * in_band_stride + src + i] : AW_INF;
    }
    R[i] = 0;  // the run band restarts with each span
  }
  // the halo after step s is in buffer (s + 1) & 1; this is "step -1"'s
  {
    int* ho = halo + wp * 6;
    if (lane == 31) {
      ho[0] = S[LPT - 1];
      ho[1] = I1[LPT - 1];
      ho[2] = TWO ? I2[LPT - 1] : AW_INF;
    }
    if (lane == 0) {
      ho[3] = S[0];
      ho[4] = D1[0];
      ho[5] = TWO ? D2[0] : AW_INF;
    }
  }
  // the neighbour blocks' halos, read over distributed shared memory:
  // the left block's last warp's entry and the right block's first's
  const int* left = r > 0 ? cluster.map_shared_rank(halo, r - 1) + (nw - 1) * 6 : nullptr;
  const int* right = r < G - 1 ? cluster.map_shared_rank(halo, r + 1) : nullptr;

  int vmin = 0, hmin = 0;
  stage_tables(qt, tt, tbl, q, t, qlen, l_pad, kb, Lb, d_lo + 1, vmin, hmin);
  // every block of the cluster has started and written its halo before
  // any neighbour reads it
  if (G > 1) cluster.sync(); else __syncthreads();

  const int q2 = 2 * qlen, t2 = 2 * tlen;
  const long long pstride = (long long)B * W;
  uint16_t* pd = planes + (long long)b * W + c0;  // the row of step s
  const int m0 = (d_lo + 1 - kb) & 1;  // the parity of the first step's moving registers
  for (int s = 0; s < n_steps; ++s) {
    const int d = d_lo + 1 + s;
    if (s > 0 && s % SW_STRETCH == 0) {
      // the last step's barrier: no thread reads the old tables
      stage_tables(qt, tt, tbl, q, t, qlen, l_pad, kb, Lb, d, vmin, hmin);
      __syncthreads();
    }
    // neighbours at k - 1 (S, I1, I2) and k + 1 (S, D1, D2): by shuffle
    // inside a warp, from the halo (written by the step before) at a
    // warp's ends, INF past the window's ends
    const int cur = (s & 1) * nw * 6;
    int sl = __shfl_up_sync(FULL, S[LPT - 1], 1);
    int i1l = __shfl_up_sync(FULL, I1[LPT - 1], 1);
    int sr = __shfl_down_sync(FULL, S[0], 1);
    int d1r = __shfl_down_sync(FULL, D1[0], 1);
    int i2l = AW_INF, d2r = AW_INF;
    if (TWO) {
      i2l = __shfl_up_sync(FULL, I2[LPT - 1], 1);
      d2r = __shfl_down_sync(FULL, D2[0], 1);
    }
    if (lane == 0) {
      if (wp > 0) {
        const int* h = halo + cur + (wp - 1) * 6;
        sl = h[0];
        i1l = h[1];
        i2l = h[2];
      } else if (left != nullptr) {
        sl = left[cur];
        i1l = left[cur + 1];
        i2l = left[cur + 2];
      } else {
        sl = i1l = i2l = AW_INF;
      }
    }
    if (lane == 31) {
      if (wp < nw - 1) {
        const int* h = halo + cur + (wp + 1) * 6;
        sr = h[3];
        d1r = h[4];
        d2r = h[5];
      } else if (right != nullptr) {
        sr = right[cur + 3];
        d1r = right[cur + 4];
        d2r = right[cur + 5];
      } else {
        sr = d1r = d2r = AW_INF;
      }
    }
    const int x = d - kt, y = d + kt;
    const uint8_t* qp = qt + ((x >> 1) - vmin);
    const uint8_t* tp = tt + ((y >> 1) - hmin);
    if ((s + m0) & 1)
      replay_step<1, LPT, TWO>(S, I1, D1, I2, D2, R, x, y, q2, t2, nin, qp, tp, sl, i1l,
                               i2l, sr, d1r, d2r, pen, pd, W);
    else
      replay_step<0, LPT, TWO>(S, I1, D1, I2, D2, R, x, y, q2, t2, nin, qp, tp, sl, i1l,
                               i2l, sr, d1r, d2r, pen, pd, W);
    int* ho = halo + (cur ^ (nw * 6)) + wp * 6;  // the other buffer
    if (lane == 31) {
      ho[0] = S[LPT - 1];
      ho[1] = I1[LPT - 1];
      ho[2] = TWO ? I2[LPT - 1] : AW_INF;
    }
    if (lane == 0) {
      ho[3] = S[0];
      ho[4] = D1[0];
      ho[5] = TWO ? D2[0] : AW_INF;
    }
    pd += pstride;
    // the halo's writes before the next step's reads (the neighbours'
    // included) and this step's reads before the step after's writes;
    // after the last step, no block exits while a neighbour may still
    // read it
    if (G > 1) sweep_barrier(); else __syncthreads();
  }

  const long long dst = (long long)b * W + c0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    if (i >= nin) continue;
    state_out[dst + i] = S[i];
    state_out[out_band_stride + dst + i] = I1[i];
    state_out[2 * out_band_stride + dst + i] = D1[i];
    // one-piece penalties leave I2 and D2 as they came
    state_out[3 * out_band_stride + dst + i] = TWO ? I2[i] : state_in[3 * in_band_stride + src + i];
    state_out[4 * out_band_stride + dst + i] = TWO ? D2[i] : state_in[4 * in_band_stride + src + i];
  }
}

// ---------------------------------------------------------------------
// the dispatch

struct Design {
  int replay;  // 1: the replay (planes), 0: the sweep
  int G;       // blocks a pair (the cluster)
  int Lb;      // lanes a block
  int lpt;     // the replay's band lanes a thread (0: the sweep)
};

int encode(const Design& g) {
  return g.replay | (g.G << 1) | (g.lpt << 6) | (g.Lb << 10);
}

// threads a sweep block: its widest half in even turns of at most 1024
int sweep_threads(int Lb) {
  const int half = Lb / 2;
  const int turns = (half + 1023) / 1024;
  const int per = (half + turns - 1) / turns;
  return (per + 31) / 32 * 32;
}

int threads_of(const Design& g) { return g.replay ? g.Lb / g.lpt : sweep_threads(g.Lb); }

int smem_of(const Design& g) {
  return g.replay ? replay_smem_bytes(g.Lb, g.lpt) : sweep_smem_bytes(g.Lb);
}

cudaLaunchConfig_t launch_config(const Design& g, int B, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * g.G);
  cfg.blockDim = dim3(threads_of(g));
  cfg.dynamicSmemBytes = smem_of(g);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

const void* kernel_of(const Design& g, int two_piece) {
  if (!g.replay)
    return two_piece ? (const void*)dense_sweep_cluster_kernel<true>
                     : (const void*)dense_sweep_cluster_kernel<false>;
  if (g.lpt == 8)
    return two_piece ? (const void*)dense_replay_cluster_kernel<8, true>
                     : (const void*)dense_replay_cluster_kernel<8, false>;
  return two_piece ? (const void*)dense_replay_cluster_kernel<4, true>
                   : (const void*)dense_replay_cluster_kernel<4, false>;
}

// what a kernel launched in the shape of g needs set first
cudaError_t set_attributes(const void* kern, const Design& g) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_of(g));
  if (e == cudaSuccess && g.G > SW_PORTABLE_G)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// clusters of design g the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code
int max_clusters(const Design& g, int two_piece) {
  const void* kern = kernel_of(g, two_piece);
  cudaError_t e = set_attributes(kern, g);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, g.G, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// the sweep: W lanes in at most maxg blocks of at least SW_MIN_LB lanes,
// Lb even
Design sweep_design(int W, int maxg) {
  const int G = min(maxg, (W + SW_MIN_LB - 1) / SW_MIN_LB);
  const int per = (W + G - 1) / G;
  const int Lb = per + (per & 1);
  return Design{0, (W + Lb - 1) / Lb, Lb, 0};
}

// the replay: W lanes in warps of 32 threads of lpt lanes, RP_WARPS
// warps a block (fewer for a narrow window) where maxg blocks take the
// window, else as many more as it needs; 4 lanes a thread, 8 where 4
// would need more than RP_MAX_WARPS warps a block. False if 8 would too.
bool replay_design(int W, int maxg, Design* g) {
  for (int lpt = 4; lpt <= 8; lpt += 4) {
    const int warps = (W + 32 * lpt - 1) / (32 * lpt);
    const int nw = max(min(RP_WARPS, warps), (warps + maxg - 1) / maxg);
    if (nw > RP_MAX_WARPS) continue;
    const int Lb = nw * 32 * lpt;
    *g = Design{1, (W + Lb - 1) / Lb, Lb, lpt};
    return true;
  }
  return false;
}

// Both designs spread a band over up to SW_MAX_G blocks where the card
// holds all B clusters at once, else over up to SW_PORTABLE_G (more of
// them fit at once), whichever fits. False for a window no design takes.
bool choose(int K, int W, int with_planes, int B, int two_piece, Design* g) {
  *g = Design{0, 1, 0, 0};
  if (W < 1 || W > K) return false;
  Design wide, portable;
  bool wide_ok, portable_ok;
  if (with_planes) {
    wide_ok = replay_design(W, SW_MAX_G, &wide);
    portable_ok = replay_design(W, SW_PORTABLE_G, &portable);
  } else {
    wide = sweep_design(W, SW_MAX_G);
    portable = sweep_design(W, SW_PORTABLE_G);
    wide_ok = sweep_smem_bytes(wide.Lb) <= SMEM_LIMIT;
    portable_ok = sweep_smem_bytes(portable.Lb) <= SMEM_LIMIT;
  }
  if (wide_ok && wide.G > SW_PORTABLE_G && max_clusters(wide, two_piece) >= B)
    *g = wide;
  else if (portable_ok)
    *g = portable;
  else if (wide_ok)
    *g = wide;
  else
    return false;
  return true;
}

template <bool TWO_PIECE>
int launch_sweep(const Design& g, const void* qs, const void* ts,
                 const void* qlens, const void* tlens, const void* c_lo, int B,
                 int l_pad, int K, int W, int d_lo, int n_steps, Pen pen,
                 const void* state_in, long long in_stride, void* state_out,
                 long long out_stride, cudaStream_t st) {
  auto* kern = dense_sweep_cluster_kernel<TWO_PIECE>;
  cudaError_t e = set_attributes((const void*)kern, g);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, B, st, &attr);
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const uint8_t*>(qs),
                         static_cast<const uint8_t*>(ts),
                         static_cast<const int*>(qlens),
                         static_cast<const int*>(tlens),
                         static_cast<const int*>(c_lo), l_pad, K, W, d_lo,
                         n_steps, g.G, g.Lb, pen,
                         static_cast<const int*>(state_in), in_stride,
                         static_cast<int*>(state_out), out_stride);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int LPT, bool TWO_PIECE>
int launch_replay(const Design& g, const void* qs, const void* ts,
                  const void* qlens, const void* tlens, const void* c_lo,
                  int B, int l_pad, int K, int W, int d_lo, int n_steps,
                  Pen pen, const void* state_in, long long in_stride,
                  void* state_out, long long out_stride, void* planes,
                  cudaStream_t st) {
  auto* kern = dense_replay_cluster_kernel<LPT, TWO_PIECE>;
  cudaError_t e = set_attributes((const void*)kern, g);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, B, st, &attr);
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const uint8_t*>(qs),
                         static_cast<const uint8_t*>(ts),
                         static_cast<const int*>(qlens),
                         static_cast<const int*>(tlens),
                         static_cast<const int*>(c_lo), B, l_pad, K, W, d_lo,
                         n_steps, g.G, pen, static_cast<const int*>(state_in),
                         in_stride, static_cast<int*>(state_out), out_stride,
                         static_cast<uint16_t*>(planes));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The design a span over a window of W lanes of a band K runs for B
// pairs, as a code: bit 0 the replay (with_planes 1) or the sweep, bits
// 1-5 the blocks a pair G (the cluster), bits 6-9 the replay's band
// lanes a thread (0 for the sweep), bits 10 and up the lanes a block
// Lb. -1 for a window no design takes.
int allwave_dense_span_design(int K, int W, int with_planes, int B,
                              int two_piece) {
  Design g;
  if (!choose(K, W, with_planes, B, two_piece, &g)) return -1;
  return encode(g);
}

// The most clusters of the span's design for B pairs at (K, W) the card
// can hold at once (cudaOccupancyMaxActiveClusters), or minus a CUDA
// error code.
int allwave_dense_span_max_clusters(int K, int W, int with_planes, int B,
                                    int two_piece) {
  Design g;
  if (!choose(K, W, with_planes, B, two_piece, &g)) return -(int)cudaErrorInvalidValue;
  return max_clusters(g, two_piece);
}

// n_steps step barriers in the launch shape (B pairs, threads, shared
// memory, cluster) of the two-piece sweep's design at (K, W): the
// sweep's own (full_fence 0) or cluster.sync() (1); out (B * G,) int32
// gets n_steps from every block.
int allwave_dense_sweep_barriers(int K, int W, int B, int n_steps,
                                 int full_fence, void* out, void* stream) {
  Design g;
  if (!choose(K, W, 0, B, 1, &g)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaError_t e = set_attributes((const void*)sweep_barrier_kernel, g);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(g, B, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, sweep_barrier_kernel, g.G, n_steps, full_fence,
                         static_cast<int*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// state_in / state_out: five (B, K) / (B, W) int32 bands, band i at
// element offset i * (in|out)_band_stride; c_lo may be null (full band,
// W == K); design: the code allwave_dense_span_design gives for (K, W,
// with_planes, B, two_piece); planes (n_steps, B, W) uint16, written
// (and not null) when with_planes.
int allwave_dense_span(const void* qs, const void* ts, const void* qlens,
                       const void* tlens, const void* c_lo, int B, int l_pad,
                       int K, int W, int d_lo, int n_steps, int x, int o1,
                       int e1, int o2, int e2, int two_piece,
                       int with_planes, int design, const void* state_in,
                       long long in_band_stride, void* state_out,
                       long long out_band_stride, void* planes, void* stream) {
  Pen pen;
  pen.x = x;
  pen.e1 = e1;
  pen.e2 = e2;
  pen.o1e1 = o1 + e1;
  pen.o2e2 = two_piece ? o2 + e2 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Design g;
  if (!choose(K, W, with_planes, B, two_piece, &g) || encode(g) != design ||
      (planes != nullptr) != (with_planes != 0))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (!g.replay) {
    return two_piece
               ? launch_sweep<true>(g, qs, ts, qlens, tlens, c_lo, B, l_pad, K,
                                    W, d_lo, n_steps, pen, state_in,
                                    in_band_stride, state_out, out_band_stride, st)
               : launch_sweep<false>(g, qs, ts, qlens, tlens, c_lo, B, l_pad,
                                     K, W, d_lo, n_steps, pen, state_in,
                                     in_band_stride, state_out, out_band_stride,
                                     st);
  }
#define AW_REPLAY(LPT, TWO)                                                       \
  launch_replay<LPT, TWO>(g, qs, ts, qlens, tlens, c_lo, B, l_pad, K, W, d_lo,    \
                          n_steps, pen, state_in, in_band_stride, state_out,      \
                          out_band_stride, planes, st)
  if (g.lpt == 8) return two_piece ? AW_REPLAY(8, true) : AW_REPLAY(8, false);
  return two_piece ? AW_REPLAY(4, true) : AW_REPLAY(4, false);
#undef AW_REPLAY
}

}  // extern "C"
