// The batched wavefront engine's two passes: the score sweep (with or
// without history) and the walk of its history.
//
// Replaces: the XLA while loops of allwave_tpu/wfa/batch.py:201
// `wavefront_forward` (a lax.while_loop over score levels whose body
// computes the five components of a (B, K) band from a (D, B, K)
// rolling buffer, and a nested while loop for the match extension) and
// :299 `wavefront_traceback` (a lax.while_loop stepping every pair's
// walker one edit a turn over the (S+1, B, K) history planes). Their
// plain twins are allwave_tpu_torch/wfa/batch.py
// `wavefront_forward_ref` and `wavefront_traceback_ref`; these kernels
// are independent of the wavefront checkpoint-replay engine's
// (wf_span.cu, wf_traceback.cu), which the engine cross-checks.
//
// What bounds them on an H100. The forward: a level is ~9 int32 ALU
// slots a lane (wf_span.cu's count) plus the extension, and with
// history 20 bytes a lane written to device memory; at the headline's
// shapes (K = 513-1025, a few hundred levels) the history bytes bound
// it. Its levels are a dependent chain: level s reads levels s - x,
// s - e and s - o - e of the neighbouring lanes, so a pair's levels run
// one after another, each behind one barrier. The traceback: one walker
// a pair, each step a few dependent reads of planes far larger than L2;
// the bound is the chain of device-memory round trips, not bytes.
//
// The forward has three designs, one table (wf_batch_tiers.cuh, and
// `choose` below for the cluster's size; exported as
// allwave_wf_batch_forward_design):
// * block and cluster, `wf_batch_ring_kernel<HIST, TWO_PIECE, STAGE>`:
//   the pair's rolling buffer as compact rings in shared memory, no
//   scratch in device memory. Each component keeps only the levels it is read
//   at: M a ring of D = max lookback + 1 rows (read at x, o1 + e1 and
//   o2 + e2 back), I1 and D1 e1 + 1 (read at e1 back), I2 and D2 e2 + 1;
//   36 rows for 0,5,8,2,24,1 instead of 5 D = 130. A row holds the
//   block's lanes between two NULL slots, so lane c reads c - 1 and
//   c + 1 with no bounds test; the ring starts all NULL, so a read below
//   score 0 finds a slot no level has written yet, NULL. Level s writes
//   slot s % depth and reads slots 1 .. depth - 1 behind it: one barrier
//   a level orders every write before the next level's reads and every
//   read before the slot's next write. The write slots are kept
//   incrementally and a read slot is one subtraction and wrap behind (no
//   division). A block of G = 1 (the block design) holds the whole band;
//   a cluster of G blocks (up to 16, non-portable above 8) splits it into
//   contiguous lane ranges, and a block's edge lane reads the
//   neighbour's edge lane of the lookback slot over distributed shared
//   memory after the level's cluster barrier (wf_span.cu's: a release
//   fence restricted to the block's shared memory, then a relaxed
//   arrive and a wait). Its levels wait on latency, not bytes: a
//   block's level is a chain of ring reads, the extension's compares,
//   the writes and the barrier. So (STAGE) the pair's two sequence rows
//   are copied into shared memory where they fit beside the rings
//   (l_pad of a few kb: the headline's), and the extension there reads
//   shared memory, not L1 or L2; the extension is a warp's
//   (wf_span.cu's): each lane compares its own next 8 bases, and the
//   lanes still matching are extended one at a time by the whole warp,
//   256 bases an iteration; and a warp none of whose diagonals the level
//   can reach (k != 0 with min open + min extend x |k| > s, or off the
//   matrix) skips to its NULL history stores. History rows go out with
//   streaming stores (__stcs), lanes in a row coalesced, in the same
//   (5, s_cap + 1, B, K) layout; rows above a finished pair's score are
//   left unwritten.
// * global, `wf_batch_global_kernel<HIST, TWO_PIECE>` (the first
//   design of the port): one block a pair, the [5][D][K] ring in device
//   memory. Each lane-level reads up to 9 ring words and writes 5 beside
//   the 20 bytes of history it must write, and a block of 1024 threads
//   holds a pair of any width, so its bound is that ring traffic, which
//   leaves L2 once the resident pairs' rings pass 50 MB (at K = 513 and
//   D = 26 a ring is 267 KB a pair). It serves only bands whose compact
//   rings do not fit a cluster of 16 blocks on an H100 (K > 25,792 for
//   the headline's penalties, so of the engine's bands K = 32769;
//   K > 54,656 for 0,5,8,2; K > 65,536 for 0,1,1,1).
// Both forwards keep the rules of the first design: the lane that holds
// the end diagonal stamps a flag with the level it reached (tlen, k_end)
// at, and a level's check after the barrier breaks only on a stamp below
// it, so a thread (or block) that runs ahead to the next level cannot
// end a slower one's level early; in a cluster the flag lives in the
// shared memory of the block holding c_end and every block reads it
// there, so all leave at the same level, and its last read is used
// before the last barrier (no block may exit while a neighbour's read of
// its shared memory is in flight). The match extension compares 8 bases
// at a time: two aligned 8-byte words a row, funnel-shifted, the first
// differing byte by find-first-set, the second word read only inside
// the row.
//
// The walk, `wf_batch_walk_kernel`: a warp a pair, WALK_WARPS pairs a
// block. Every lane carries the same walker state and takes the same
// branches; the walker's steps are the reference's (the M state's five
// candidates in the tie order X, I1, I2, D1, D2, the gap states' extend
// before open, the M run then the X emit, a run index clamped to
// run_cap - 1 while nrun counts on, overflow once nrun >= run_cap, a
// walker still active after 3 * run_cap + 8 steps flagged as overflow).
// What changes is where a step's cells come from: a round trip loads, on
// separate lanes, the cells the walker needs now and those it can reach
// before it needs a new round (`walk_cell`):
//   in the M state at (s, c): its five candidates (M at s - x, I1, D1,
//     I2, D2 at s), the five of its next two X successors (s - x, c) and
//     (s - 2x, c), and the first WALK_NCH cells of each gap chain it may
//     enter, (s - j e, c -+ j);
//   in a gap state at (s, c): the chain's next 32 cells (s - j e, c -+ j),
//     j = 1 .. 32, the last one it reads being the open it ends at.
// The walker finds each cell by a ballot over the lanes' coordinates and
// takes it by shuffle; a cell the round did not load starts the next
// round. So three M steps whose first two are mismatches cost one round
// trip, a gap of up to WALK_NCH bases one, a gap run of up to 32 one
// more. It reads
// nothing above scores[b]. Optional stats: steps and round trips a pair.
// `wf_batch_thread_kernel` is the first design (a thread a pair, one
// dependent read a cell), kept only so the smoke times both in one call.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wf_batch_tiers.cuh"

#define AW_NULL (-(1 << 30))

namespace cg = cooperative_groups;
using namespace wf_batch_tiers;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kComps = 5;  // m, i1, d1, i2, d2: the planes' order
constexpr int kMaxThreads = 1024;
constexpr int kTbThreads = 128;
constexpr int kCM = 0, kCI1 = 1, kCD1 = 2, kCI2 = 3, kCD2 = 4;
constexpr int WALK_WARPS = 4;  // pairs (warps) a block of the walk
constexpr int WALK_XCH = 3;    // M positions an M round loads: (s - j x, c), j < WALK_XCH
constexpr int WALK_NCH = 4;    // cells of each gap chain an M round loads
constexpr int PAT_M = 0;       // a round's pattern: the M state's, or the gap plane's

// the penalties as the recurrences read them; gap0 and gmin, the least
// gap open and extend of either piece, bound the diagonals a level can
// reach: a value on diagonal k != 0 at score s needs |k| gap bases, so
// gap0 + gmin |k| <= s
struct WfPen {
  int x, o1e1, e1, o2e2, e2;
  int gap0, gmin;
};

// the compact rings: row offsets and depths of M, I1, D1, I2, D2
struct Ring {
  int dm, d1, d2;
  int om, oi1, od1, oi2, od2;
  int rows;
};

// The level barrier across a cluster (wf_span.cu's): each thread's
// release fence restricted to its own block's shared memory, a relaxed
// arrive and an acquiring wait.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "fence.release.sync_restrict::shared::cta.cluster;\n"
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Bytes p .. p + 7 of a row of nw 8-byte words, little-endian; zeros
// past the row's last word.
__device__ __forceinline__ unsigned long long load8(const unsigned long long* __restrict__ w,
                                                    int p, int nw) {
  const int i = p >> 3;
  const int sh = (p & 7) << 3;
  const unsigned long long lo = w[i];
  if (sh == 0) return lo;
  const unsigned long long hi = i + 1 < nw ? w[i + 1] : 0ull;
  return (lo >> sh) | (hi << (64 - sh));
}

// The offset h (query position v = h - k) advanced along matching
// bases, at most to hmax: min(the common prefix, hmax - h), which is
// what the reference's 4-byte loop computes.
__device__ __forceinline__ int extend(const unsigned long long* __restrict__ q,
                                      const unsigned long long* __restrict__ t, int nw,
                                      int v, int h, int hmax) {
  while (h < hmax) {
    const unsigned long long x = load8(q, v, nw) ^ load8(t, h, nw);
    const int n = x ? (__ffsll((long long)x) - 1) >> 3 : 8;
    if (n >= hmax - h) return hmax;
    h += n;
    v += n;
    if (n < 8) break;
  }
  return h;
}

// the first differing byte of q[v .. v + n) and t[p .. p + n) (n <= 8),
// or 8 if they are equal there
__device__ __forceinline__ int first_stop8(const unsigned long long* __restrict__ q,
                                           const unsigned long long* __restrict__ t, int v,
                                           int p, int n, int nw) {
  const unsigned long long x = load8(q, v, nw) ^ load8(t, p, nw);
  const int i = x ? (__ffsll((long long)x) - 1) >> 3 : 8;
  return i < n ? i : 8;
}

// `extend` for every lane of a warp at once, called by all 32 threads
// together (wf_span.cu's extend_warp): a thread whose lane is `act` with
// NULL < h < hmax on diagonal k gets extend's offset, any other h comes
// back. Each lane compares its own next 8 bases; the lanes still
// matching are then extended one at a time by the whole warp, 32 x 8
// bases an iteration, the first stop found by a ballot.
__device__ __forceinline__ int extend_warp(bool act, int h, int hmax, int k,
                                           const unsigned long long* __restrict__ q,
                                           const unsigned long long* __restrict__ t, int nw) {
  int pos = h, p = 0;
  bool pend = false;
  if (act && h > AW_NULL && h < hmax) {
    const int i = first_stop8(q, t, h - k, h, min(hmax - h, 8), nw);
    if (i < 8) {
      pos = h + i;
    } else if (hmax - h <= 8) {
      pos = hmax;
    } else {
      pend = true;
      p = h + 8;
    }
  }
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(FULL, pend);
  while (todo != 0) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    int pp = __shfl_sync(FULL, p, src);
    const int kk = __shfl_sync(FULL, k, src);
    const int hh = __shfl_sync(FULL, hmax, src);
    int found = hh;
    for (;;) {
      const int base = pp + 8 * lane;
      const int i = base < hh ? first_stop8(q, t, base - kk, base, min(hh - base, 8), nw) : 8;
      const unsigned hit = __ballot_sync(FULL, i < 8);
      if (hit != 0) {
        found = __shfl_sync(FULL, base + i, __ffs(hit) - 1);
        break;
      }
      pp += 256;
      if (pp >= hh) break;
    }
    if (lane == src) pos = found;
  }
  return pos;
}

// a ring slot `back` levels behind the write slot w of a ring of depth d
__device__ __forceinline__ int back_slot(int w, int back, int d) {
  const int r = w - back;
  return r < 0 ? r + d : r;
}

__device__ __forceinline__ int plus1(int v) { return v > AW_NULL ? v + 1 : AW_NULL; }

__device__ __forceinline__ int trim(int v, int hm) { return v > hm ? AW_NULL : v; }

// ---------------------------------------------------------------------
// the forward: block and cluster designs

template <bool HIST, bool TWO_PIECE, bool STAGE>
__global__ void __launch_bounds__(kMaxThreads, 1) wf_batch_ring_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens, int B, int l_pad, int K,
    int s_cap, int G, int Lb, int lpt, Ring rg, WfPen pen, int* __restrict__ hist,
    int* __restrict__ scores, uint8_t* __restrict__ done_out) {
  extern __shared__ __align__(16) int smem[];  // [rows][Lb + 2], the stamp, (the rows)
  cg::cluster_group cluster = cg::this_cluster();
  const int r = G > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int qlen = qlens[b], tlen = tlens[b];
  const int k_end = tlen - qlen;
  const int abs_end = k_end < 0 ? -k_end : k_end;
  const int k0 = min(0, k_end) - ((K - 1 - abs_end) >> 1);  // floor, as the reference
  const int c_end = min(max(k_end - k0, 0), K - 1);
  const bool feasible = abs_end <= K - 1;
  const int nw = l_pad >> 3;
  const auto* q = reinterpret_cast<const unsigned long long*>(qs + (size_t)b * l_pad);
  const auto* t = reinterpret_cast<const unsigned long long*>(ts + (size_t)b * l_pad);
  const int S = Lb + 2;                  // a ring row: NULL, Lb lanes, NULL
  const int c_first = r * Lb;            // this block's lanes [c_first, c_first + n_r)
  const int n_r = min(Lb, K - c_first);  // >= 1
  const int kb = k0 + c_first;           // k of local lane c is kb + c
  // this block's local lane at c_end, if it holds it and the pair is feasible
  const int end_lane = feasible && c_end >= c_first && c_end < c_first + n_r ? c_end - c_first : -1;
  const size_t hrow = (size_t)B * K;
  const size_t hplane = (size_t)(s_cap + 1) * hrow;
  int* hb = HIST ? hist + (size_t)b * K + c_first : nullptr;  // + comp * hplane + s * hrow + c

  int* stamp = smem + rg.rows * S;  // the level the pair reached its end at
  for (int i = tid; i < rg.rows * S; i += nt) smem[i] = AW_NULL;
  if (tid == 0) *stamp = INT_MAX;
  if (STAGE) {  // the pair's rows into shared memory, from a 16-byte boundary
    auto* sq = reinterpret_cast<unsigned long long*>(smem + ((rg.rows * S + 4 + 3) & ~3));
    for (int i = tid; i < nw; i += nt) {
      sq[i] = q[i];
      sq[nw + i] = t[i];
    }
    q = sq;
    t = sq + nw;
  }
  __syncthreads();

  // score 0: M = 0 on diagonal 0, extended; the other components NULL.
  // Lanes are walked as thread tid's lanes tid + it nt, it < lpt, by every
  // thread (the extension is a warp's): the block's threads are whole warps
  for (int it = 0; it < lpt; ++it) {
    const int c = tid + it * nt;
    const bool in = c < n_r;
    const int k = kb + c;
    const int hm = (k >= -qlen && k <= tlen) ? min(tlen, qlen + k) : -1;
    int m = extend_warp(in, k == 0 ? 0 : AW_NULL, hm, k, q, t, nw);
    if (!in) continue;
    m = trim(m, hm);
    smem[rg.om * S + c + 1] = m;
    if (HIST) {
      __stcs(hb + c, m);
      for (int comp = 1; comp < kComps; ++comp) __stcs(hb + comp * hplane + c, AW_NULL);
    }
    if (c == end_lane && m == tlen) *stamp = 0;
  }
  // the neighbours' rings (their edge lanes: the left block's last lane at
  // index Lb, the right block's first at 1) and the stamp of the block
  // holding c_end
  const int* left = nullptr;
  const int* right = nullptr;
  const volatile int* dstamp = stamp;
  if (G > 1) {
    if (r > 0) left = cluster.map_shared_rank(smem, r - 1);
    if (r < G - 1) right = cluster.map_shared_rank(smem, r + 1);
    dstamp = cluster.map_shared_rank(stamp, min(c_end / Lb, G - 1));
    cluster.sync();  // every block has started, and level 0 is in its ring
  } else {
    __syncthreads();
  }

  int wm = 0, w1 = 0, w2 = 0;  // the write slots of level s
  for (int s = 1; s <= s_cap; ++s) {
    if (*dstamp < s) break;
    wm = wm + 1 == rg.dm ? 0 : wm + 1;
    w1 = w1 + 1 == rg.d1 ? 0 : w1 + 1;
    // the rows this level reads and writes, uniform across the cluster
    const int pmx = (rg.om + back_slot(wm, pen.x, rg.dm)) * S;
    const int pmo1 = (rg.om + back_slot(wm, pen.o1e1, rg.dm)) * S;
    const int s1 = back_slot(w1, pen.e1, rg.d1);
    const int pi1 = (rg.oi1 + s1) * S, pd1 = (rg.od1 + s1) * S;
    const int wM = (rg.om + wm) * S, wI1 = (rg.oi1 + w1) * S, wD1 = (rg.od1 + w1) * S;
    int pmo2 = 0, pi2 = 0, pd2 = 0, wI2 = 0, wD2 = 0;
    if (TWO_PIECE) {
      w2 = w2 + 1 == rg.d2 ? 0 : w2 + 1;
      const int s2 = back_slot(w2, pen.e2, rg.d2);
      pmo2 = (rg.om + back_slot(wm, pen.o2e2, rg.dm)) * S;
      pi2 = (rg.oi2 + s2) * S;
      pd2 = (rg.od2 + s2) * S;
      wI2 = (rg.oi2 + w2) * S;
      wD2 = (rg.od2 + w2) * S;
    }
    for (int it = 0; it < lpt; ++it) {
      const int c = tid + it * nt;
      const bool in = c < n_r;
      const int k = kb + c;
      const int hm = (k >= -qlen && k <= tlen) ? min(tlen, qlen + k) : -1;
      // a warp none of whose lanes can hold a value at this level (off the
      // matrix, or farther from diagonal 0 than s pays for; so at every
      // earlier level too, and its ring slots are still NULL) writes its
      // NULL history rows and nothing else
      const int ak = k < 0 ? -k : k;
      const bool live = in && hm >= 0 && (k == 0 || pen.gap0 + pen.gmin * ak <= s);
      if (!__any_sync(FULL, live)) {
        if (HIST && in) {
          int* row = hb + s * hrow + c;
          for (int comp = 0; comp < kComps; ++comp) __stcs(row + comp * hplane, AW_NULL);
        }
        continue;
      }
      int i1 = AW_NULL, d1 = AW_NULL, i2 = AW_NULL, d2 = AW_NULL, m = AW_NULL;
      if (in) {
        // lane c - 1 (index c): M and I1 (I2); lane c + 1 (index c + 2): M
        // and D1 (D2); a block's edge lanes from the neighbour's ring
        int ml1, il1, ml2 = AW_NULL, il2 = AW_NULL;
        if (c == 0 && left != nullptr) {
          const int* a = left + Lb;
          ml1 = a[pmo1];
          il1 = a[pi1];
          if (TWO_PIECE) {
            ml2 = a[pmo2];
            il2 = a[pi2];
          }
        } else {
          const int* a = smem + c;
          ml1 = a[pmo1];
          il1 = a[pi1];
          if (TWO_PIECE) {
            ml2 = a[pmo2];
            il2 = a[pi2];
          }
        }
        int mr1, dr1, mr2 = AW_NULL, dr2 = AW_NULL;
        if (c == n_r - 1 && right != nullptr) {
          const int* z = right + 1;
          mr1 = z[pmo1];
          dr1 = z[pd1];
          if (TWO_PIECE) {
            mr2 = z[pmo2];
            dr2 = z[pd2];
          }
        } else {
          const int* z = smem + c + 2;
          mr1 = z[pmo1];
          dr1 = z[pd1];
          if (TWO_PIECE) {
            mr2 = z[pmo2];
            dr2 = z[pd2];
          }
        }
        i1 = trim(plus1(max(ml1, il1)), hm);
        d1 = trim(max(mr1, dr1), hm);
        int best = max(i1, d1);
        if (TWO_PIECE) {
          i2 = trim(plus1(max(ml2, il2)), hm);
          d2 = trim(max(mr2, dr2), hm);
          best = max(best, max(i2, d2));
        }
        m = max(best, trim(plus1(smem[pmx + c + 1]), hm));
      }
      m = extend_warp(in, m, hm, k, q, t, nw);
      if (!in) continue;
      m = trim(m, hm);
      smem[wM + c + 1] = m;
      smem[wI1 + c + 1] = i1;
      smem[wD1 + c + 1] = d1;
      if (TWO_PIECE) {
        smem[wI2 + c + 1] = i2;
        smem[wD2 + c + 1] = d2;
      }
      if (HIST) {
        int* row = hb + s * hrow + c;
        __stcs(row, m);
        __stcs(row + hplane, i1);
        __stcs(row + 2 * hplane, d1);
        __stcs(row + 3 * hplane, i2);
        __stcs(row + 4 * hplane, d2);
      }
      if (c == end_lane && m == tlen) *stamp = s;
    }
    // this level's writes before the next level's reads (the neighbours'
    // included) and its reads before the next level's writes
    if (G > 1) cluster_barrier(); else __syncthreads();
  }
  // the stamp is final here (no level runs after the last barrier). Its
  // read is used (stored) before the last barrier: a relaxed arrive does
  // not wait for a load still in flight, and no block may exit while a
  // neighbour's read of its ring or stamp is outstanding
  if (r == 0 && tid == 0) {
    const int done_at = *dstamp;
    const bool done = done_at != INT_MAX;
    scores[b] = done ? done_at : -1;
    done_out[b] = done;
  }
  if (G > 1) cluster_barrier();
}

// ---------------------------------------------------------------------
// the forward: the global design

template <bool HIST, bool TWO_PIECE>
__global__ void __launch_bounds__(kMaxThreads) wf_batch_global_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens, int B, int l_pad, int K,
    int s_cap, int D, WfPen pen, int* ring, int* hist, int* __restrict__ scores,
    uint8_t* __restrict__ done_out) {
  __shared__ int done_at;  // the level the pair reached its end at
  const int b = blockIdx.x;
  const int qlen = qlens[b], tlen = tlens[b];
  const int k_end = tlen - qlen;
  const int abs_end = k_end < 0 ? -k_end : k_end;
  const int k0 = min(0, k_end) - ((K - 1 - abs_end) >> 1);  // floor, as the reference
  const int c_end = min(max(k_end - k0, 0), K - 1);
  const bool feasible = abs_end <= K - 1;
  const int nw = l_pad >> 3;
  const auto* q = reinterpret_cast<const unsigned long long*>(qs + (size_t)b * l_pad);
  const auto* t = reinterpret_cast<const unsigned long long*>(ts + (size_t)b * l_pad);
  int* rb = ring + (size_t)b * kComps * D * K;  // [comp][slot][c]
  const size_t hrow = (size_t)B * K;
  const size_t hplane = (size_t)(s_cap + 1) * hrow;
  int* hb = HIST ? hist + (size_t)b * K : nullptr;  // + comp * hplane + s * hrow + c
  if (threadIdx.x == 0) done_at = INT_MAX;
  __syncthreads();

  // score 0: M = 0 on diagonal 0, extended; the other components NULL
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    const int k = k0 + c;
    const int hmax = (k >= -qlen && k <= tlen) ? min(tlen, qlen + k) : -1;
    int m = k == 0 ? 0 : AW_NULL;
    if (m > AW_NULL && m < hmax) m = extend(q, t, nw, m - k, m, hmax);
    if (m > hmax) m = AW_NULL;
    rb[c] = m;
    for (int comp = 1; comp < kComps; ++comp) rb[(size_t)comp * D * K + c] = AW_NULL;
    if (HIST) {
      hb[c] = m;
      for (int comp = 1; comp < kComps; ++comp) hb[comp * hplane + c] = AW_NULL;
    }
    if (c == c_end && feasible && m == tlen) done_at = 0;
  }
  __syncthreads();

  int slot = 0;  // s % D
  for (int s = 1; s <= s_cap && done_at >= s; ++s) {
    slot = slot + 1 == D ? 0 : slot + 1;
    // the slots of levels s - ds (1 <= ds < D), or -1 below score 0
    const auto from = [&](int ds) { return s < ds ? -1 : (slot < ds ? slot - ds + D : slot - ds); };
    const int sx = from(pen.x), so1 = from(pen.o1e1), se1 = from(pen.e1);
    const int so2 = TWO_PIECE ? from(pen.o2e2) : -1, se2 = TWO_PIECE ? from(pen.e2) : -1;
    const auto rd = [&](int comp, int sl, int c) {
      return (sl >= 0 && c >= 0 && c < K) ? rb[((size_t)comp * D + sl) * K + c] : AW_NULL;
    };
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const int k = k0 + c;
      const int hmax = (k >= -qlen && k <= tlen) ? min(tlen, qlen + k) : -1;
      // I1[s][k] = max(M[s-o1-e1][k-1], I1[s-e1][k-1]) + 1
      int i1 = max(rd(kCM, so1, c - 1), rd(kCI1, se1, c - 1));
      i1 = i1 > AW_NULL ? i1 + 1 : AW_NULL;
      if (i1 > hmax) i1 = AW_NULL;
      // D1[s][k] = max(M[s-o1-e1][k+1], D1[s-e1][k+1])
      int d1 = max(rd(kCM, so1, c + 1), rd(kCD1, se1, c + 1));
      if (d1 > hmax) d1 = AW_NULL;
      int best = max(i1, d1);
      int i2 = AW_NULL, d2 = AW_NULL;
      if (TWO_PIECE) {
        i2 = max(rd(kCM, so2, c - 1), rd(kCI2, se2, c - 1));
        i2 = i2 > AW_NULL ? i2 + 1 : AW_NULL;
        if (i2 > hmax) i2 = AW_NULL;
        d2 = max(rd(kCM, so2, c + 1), rd(kCD2, se2, c + 1));
        if (d2 > hmax) d2 = AW_NULL;
        best = max(best, max(i2, d2));
      }
      int mis = rd(kCM, sx, c);
      mis = mis > AW_NULL ? mis + 1 : AW_NULL;
      if (mis > hmax) mis = AW_NULL;
      int m = max(best, mis);
      if (m > AW_NULL && m < hmax) m = extend(q, t, nw, m - k, m, hmax);
      if (m > hmax) m = AW_NULL;
      int* w = rb + (size_t)slot * K + c;
      const size_t cs = (size_t)D * K;
      w[0] = m;
      w[cs] = i1;
      w[2 * cs] = d1;
      w[3 * cs] = i2;
      w[4 * cs] = d2;
      if (HIST) {
        int* r = hb + s * hrow + c;
        r[0] = m;
        r[hplane] = i1;
        r[2 * hplane] = d1;
        r[3 * hplane] = i2;
        r[4 * hplane] = d2;
      }
      if (c == c_end && feasible && m == tlen) done_at = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const bool done = done_at != INT_MAX;
    scores[b] = done ? done_at : -1;
    done_out[b] = done;
  }
}

// ---------------------------------------------------------------------
// the walk

// The cell lane l loads in a round of pattern pat (PAT_M, or the gap
// plane 1-4) from (s, c): its plane, level and lane, or plane -1 for
// none. M: lanes 5 j .. 5 j + 4 the five candidates at (s - j x, c),
// the M state and its X successors, j < WALK_XCH, then WALK_NCH cells of
// each gap chain from (s, c); a gap plane: lane j its chain's cell j + 1.
__device__ __forceinline__ void walk_cell(int pat, int l, int s, int c, const WfPen& pen,
                                          int& pl, int& cs, int& cc) {
  int g = pat, j = l + 1;
  if (pat == PAT_M) {
    constexpr int NX = 5 * WALK_XCH;
    if (l < NX) {
      const int s0 = s - (l / 5) * pen.x;
      pl = l % 5;
      cs = pl == kCM ? s0 - pen.x : s0;
      cc = c;
      return;
    }
    if (l >= NX + 4 * WALK_NCH) {
      pl = -1;
      cs = cc = 0;
      return;
    }
    g = 1 + (l - NX) / WALK_NCH;
    j = 1 + (l - NX) % WALK_NCH;
  }
  const bool ins = g == kCI1 || g == kCI2;
  pl = g;
  cs = s - j * (g <= kCD1 ? pen.e1 : pen.e2);
  cc = ins ? c - j : c + j;
}

__global__ void __launch_bounds__(32 * WALK_WARPS) wf_batch_walk_kernel(
    const int* __restrict__ pm, const int* __restrict__ pi1, const int* __restrict__ pd1,
    const int* __restrict__ pi2, const int* __restrict__ pd2, const int* __restrict__ scores,
    const int* __restrict__ qlens, const int* __restrict__ tlens, int S1, int B, int K,
    WfPen pen, int run_cap, uint8_t* __restrict__ ops, int* __restrict__ lens,
    int* __restrict__ nruns, uint8_t* __restrict__ overflow, int* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WALK_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const size_t hrow = (size_t)B * K;
  const int qlen = qlens[b], tlen = tlens[b];
  const int k_end = tlen - qlen;
  const int abs_end = k_end < 0 ? -k_end : k_end;
  const int k0 = min(0, k_end) - ((K - 1 - abs_end) >> 1);
  int c = k_end - k0;  // unclipped, as the reference's walk
  int s = scores[b], h = tlen, comp = kCM, nrun = 0;
  bool active = s >= 0, ovf = false;
  uint8_t* o = ops + (size_t)b * run_cap;
  int* l = lens + (size_t)b * run_cap;
  const auto emit = [&](int op, int count) {
    if (count > 0) {
      const int idx = min(max(nrun, 0), run_cap - 1);
      if (lane == 0) {
        o[idx] = (uint8_t)op;
        l[idx] = count;
      }
      ++nrun;
    }
  };
  // the cell this lane holds of the round (plane -1: none) and its value
  int hp = -1, hs = 0, hc = 0, hv = AW_NULL;
  int rounds = 0;
  const auto load_round = [&](int pat) {
    walk_cell(pat, lane, s, c, pen, hp, hs, hc);
    hv = AW_NULL;
    if (hp >= 0 && hs >= 0 && hs < S1 && hc >= 0 && hc < K) {
      const int* p = hp == kCM ? pm : hp == kCI1 ? pi1 : hp == kCD1 ? pd1 : hp == kCI2 ? pi2 : pd2;
      hv = __ldg(p + hs * hrow + (size_t)b * K + hc);
    }
    ++rounds;
  };
  // the lane holding (pl, ss, cc), or -1 if the round did not load it
  const auto find = [&](int pl, int ss, int cc) {
    const unsigned hit = __ballot_sync(FULL, hp == pl && hs == ss && hc == cc);
    return hit ? __ffs(hit) - 1 : -1;
  };
  const long long max_iters = 3LL * run_cap + 8;
  long long it = 0;
  for (; active && it < max_iters; ++it) {
    if (comp == kCM) {
      int src[kComps];
      bool all = true;
#pragma unroll
      for (int p = 0; p < kComps; ++p) {
        src[p] = find(p, p == kCM ? s - pen.x : s, c);
        all = all && src[p] >= 0;
      }
      if (!all) {
        load_round(PAT_M);
#pragma unroll
        for (int p = 0; p < kComps; ++p) src[p] = find(p, p == kCM ? s - pen.x : s, c);
      }
      const bool at_origin = s == 0;
      const int mv = __shfl_sync(FULL, hv, src[kCM]);
      const int cx = mv > AW_NULL ? mv + 1 : AW_NULL;
      const int ci1 = __shfl_sync(FULL, hv, src[kCI1]);
      const int cd1 = __shfl_sync(FULL, hv, src[kCD1]);
      const int ci2 = __shfl_sync(FULL, hv, src[kCI2]);
      const int cd2 = __shfl_sync(FULL, hv, src[kCD2]);
      const int pre = max(max(max(cx, ci1), max(cd1, ci2)), cd2);
      const int choice = cx == pre    ? kCM
                         : ci1 == pre ? kCI1
                         : ci2 == pre ? kCI2
                         : cd1 == pre ? kCD1
                                      : kCD2;
      emit('M', at_origin ? h : h - pre);
      if (!at_origin && choice == kCM) emit('X', 1);
      ovf = nrun >= run_cap;
      active = !at_origin && !ovf;
      if (active) {
        if (choice == kCM) {
          s -= pen.x;
          h = pre - 1;
        } else {
          h = pre;
        }
        comp = choice;
      }
    } else {
      const bool is_i = comp == kCI1 || comp == kCI2;
      const bool piece1 = comp == kCI1 || comp == kCD1;
      const int e = piece1 ? pen.e1 : pen.e2;
      const int nc = is_i ? c - 1 : c + 1;
      int src = find(comp, s - e, nc);
      if (src < 0) {
        load_round(comp);
        src = find(comp, s - e, nc);
      }
      const int ext = __shfl_sync(FULL, hv, src);
      const bool ext_ok = ext > AW_NULL && (is_i ? ext + 1 == h : ext == h);
      emit(is_i ? 'I' : 'D', 1);
      ovf = nrun >= run_cap;
      active = !ovf;
      if (active) {
        s -= ext_ok ? e : (piece1 ? pen.o1e1 : pen.o2e2);
        c = nc;
        if (is_i) --h;
        if (!ext_ok) comp = kCM;
      }
    }
  }
  if (lane == 0) {
    nruns[b] = nrun;
    overflow[b] = ovf || active;
    if (stats != nullptr) {
      stats[b] = (int)it;
      stats[B + b] = rounds;
    }
  }
}

__global__ void __launch_bounds__(kTbThreads) wf_batch_thread_kernel(
    const int* __restrict__ pm, const int* __restrict__ pi1, const int* __restrict__ pd1,
    const int* __restrict__ pi2, const int* __restrict__ pd2, const int* __restrict__ scores,
    const int* __restrict__ qlens, const int* __restrict__ tlens, int S1, int B, int K,
    WfPen pen, int run_cap, uint8_t* __restrict__ ops, int* __restrict__ lens,
    int* __restrict__ nruns, uint8_t* __restrict__ overflow) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t hrow = (size_t)B * K;
  const auto fetch = [&](const int* p, int s, int c) {
    return (s >= 0 && s < S1 && c >= 0 && c < K) ? p[s * hrow + (size_t)b * K + c] : AW_NULL;
  };
  const int qlen = qlens[b], tlen = tlens[b];
  const int k_end = tlen - qlen;
  const int abs_end = k_end < 0 ? -k_end : k_end;
  const int k0 = min(0, k_end) - ((K - 1 - abs_end) >> 1);
  int c = k_end - k0;  // unclipped, as the reference's walk
  int s = scores[b], h = tlen, comp = kCM, nrun = 0;
  bool active = s >= 0, ovf = false;
  uint8_t* o = ops + (size_t)b * run_cap;
  int* l = lens + (size_t)b * run_cap;
  const auto emit = [&](int op, int count) {
    if (count > 0) {
      const int idx = min(max(nrun, 0), run_cap - 1);
      o[idx] = (uint8_t)op;
      l[idx] = count;
      ++nrun;
    }
  };
  const long long max_iters = 3LL * run_cap + 8;
  for (long long it = 0; active && it < max_iters; ++it) {
    if (comp == kCM) {
      const bool at_origin = s == 0;
      const int mv = fetch(pm, s - pen.x, c);
      const int cx = mv > AW_NULL ? mv + 1 : AW_NULL;
      const int ci1 = fetch(pi1, s, c), cd1 = fetch(pd1, s, c);
      const int ci2 = fetch(pi2, s, c), cd2 = fetch(pd2, s, c);
      const int pre = max(max(max(cx, ci1), max(cd1, ci2)), cd2);
      const int choice = cx == pre    ? kCM
                         : ci1 == pre ? kCI1
                         : ci2 == pre ? kCI2
                         : cd1 == pre ? kCD1
                                      : kCD2;
      emit('M', at_origin ? h : h - pre);
      if (!at_origin && choice == kCM) emit('X', 1);
      ovf = nrun >= run_cap;
      active = !at_origin && !ovf;
      if (active) {
        if (choice == kCM) {
          s -= pen.x;
          h = pre - 1;
        } else {
          h = pre;
        }
        comp = choice;
      }
    } else {
      const bool is_i = comp == kCI1 || comp == kCI2;
      const bool piece1 = comp == kCI1 || comp == kCD1;
      const int e = piece1 ? pen.e1 : pen.e2;
      const int* plane = comp == kCI1 ? pi1 : comp == kCI2 ? pi2 : comp == kCD1 ? pd1 : pd2;
      const int ext = fetch(plane, s - e, is_i ? c - 1 : c + 1);
      const bool ext_ok = ext > AW_NULL && (is_i ? ext + 1 == h : ext == h);
      emit(is_i ? 'I' : 'D', 1);
      ovf = nrun >= run_cap;
      active = !ovf;
      if (active) {
        s -= ext_ok ? e : (piece1 ? pen.o1e1 : pen.o2e2);
        c += is_i ? -1 : 1;
        if (is_i) --h;
        if (!ext_ok) comp = kCM;
      }
    }
  }
  nruns[b] = nrun;
  overflow[b] = ovf || active;
}

// ---------------------------------------------------------------------
// host side: the forward's design, its launch shape and the launch

struct Design {
  int tier, staged, G, lpt, Lb;
};

Design decode(int code) {
  return Design{code & 3, (code >> 2) & 1, (code >> 3) & 31, (code >> 8) & 15, code >> 12};
}

Ring ring_of(int D, int e1, int e2, int two_piece) {
  Ring rg;
  rg.dm = D;
  rg.d1 = e1 + 1;
  rg.d2 = two_piece ? e2 + 1 : 1;
  rg.om = 0;
  rg.oi1 = D;
  rg.od1 = D + rg.d1;
  rg.oi2 = D + 2 * rg.d1;
  rg.od2 = rg.oi2 + (two_piece ? rg.d2 : 0);
  rg.rows = ring_rows(D, e1, e2, two_piece);
  return rg;
}

template <bool HIST, bool TWO_PIECE>
const void* ring_kernel_of(int staged) {
  return staged ? (const void*)wf_batch_ring_kernel<HIST, TWO_PIECE, true>
                : (const void*)wf_batch_ring_kernel<HIST, TWO_PIECE, false>;
}

const void* ring_kernel_of(int hist, int two_piece, int staged) {
  if (hist) return two_piece ? ring_kernel_of<true, true>(staged) : ring_kernel_of<true, false>(staged);
  return two_piece ? ring_kernel_of<false, true>(staged) : ring_kernel_of<false, false>(staged);
}

// a block's shared memory in design g
int smem_of(const Design& g, int rows, int l_pad) {
  return (int)block_smem(g.Lb, rows, g.staged ? 2LL * l_pad : 0);
}

cudaLaunchConfig_t launch_config(const Design& g, int rows, int l_pad, int B, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * g.G);
  cfg.blockDim = dim3(block_threads(g.Lb));
  cfg.dynamicSmemBytes = (size_t)smem_of(g, rows, l_pad);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// what a ring kernel launched in the shape of g needs set first
cudaError_t set_attributes(const void* kern, const Design& g, int rows, int l_pad) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_of(g, rows, l_pad));
  if (e == cudaSuccess && g.G > TIER_PORTABLE_G)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// clusters (or blocks) of design g the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code
int max_clusters(const Design& g, int rows, int l_pad, int two_piece) {
  const void* kern = ring_kernel_of(1, two_piece, g.staged);
  cudaError_t e = set_attributes(kern, g, rows, l_pad);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, rows, l_pad, g.G, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The design for B pairs on a band of K lanes (wf_batch_tiers.cuh's
// table on this card's shared memory and SM count). A cluster's size:
// the table's least G up to 16 blocks (non-portable above 8) and up to
// 8; the first whose B clusters all fit at once
// (cudaOccupancyMaxActiveClusters), else the one with the fewest waves.
// force: -1 the table's choice, TIER_GLOBAL the global design (for
// timing it beside the others). *held: the design's clusters the card
// holds at once (0 for global), or minus a CUDA error code. -1 where no
// design takes the shape.
int choose(int K, int B, int l_pad, int rows, int two_piece, int force, int* held) {
  *held = 0;
  if (K < 1 || rows < 1 || l_pad < 0 || (force != -1 && force != TIER_GLOBAL)) return -1;
  if (force == TIER_GLOBAL) return tier_code(TIER_GLOBAL, 1, 0);
  int dev = 0, smem = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) {
    *held = -(int)e;
    return -1;
  }
  const int code = tier_of(K, B, l_pad, rows, smem, n_sm, TIER_MAX_G);
  const Design g = decode(code);
  if (g.tier == TIER_GLOBAL) return code;
  int cands[2] = {code, -1};
  if (g.tier == TIER_CLUSTER && g.G > TIER_PORTABLE_G)
    cands[1] = tier_of(K, B, l_pad, rows, smem, n_sm, TIER_PORTABLE_G);
  int best = code;
  long long best_waves = -1;
  for (int i = 0; i < 2; ++i) {
    if (cands[i] < 0 || decode(cands[i]).tier != g.tier) continue;
    const int n = max_clusters(decode(cands[i]), rows, l_pad, two_piece);
    const long long waves = n > 0 ? (B + n - 1) / n : (1LL << 40);
    if (best_waves < 0 || waves < best_waves) {
      best = cands[i];
      *held = n;
      best_waves = waves;
    }
    if (waves <= 1) break;
  }
  return best;
}

template <bool HIST, bool TWO_PIECE, bool STAGE>
cudaError_t launch_ring(const cudaLaunchConfig_t& cfg, const uint8_t* qs, const uint8_t* ts,
                        const int* qlens, const int* tlens, int B, int l_pad, int K, int s_cap,
                        const Design& g, const Ring& rg, const WfPen& pen, int* hist,
                        int* scores, uint8_t* done) {
  auto* kern = wf_batch_ring_kernel<HIST, TWO_PIECE, STAGE>;
  return cudaLaunchKernelEx(&cfg, kern, qs, ts, qlens, tlens, B, l_pad, K, s_cap, g.G, g.Lb,
                            g.lpt, rg, pen, hist, scores, done);
}

// whether code g is a design a forward over a band of K lanes may launch
bool launchable(const Design& g, int K, int rows, int l_pad, int smem) {
  if (g.tier == TIER_GLOBAL) return g.G == 1 && !g.staged;
  if (g.tier != TIER_BLOCK && g.tier != TIER_CLUSTER) return false;
  return g.G >= 1 && g.G <= TIER_MAX_G && (g.tier == TIER_BLOCK) == (g.G == 1) &&
         (K + g.Lb - 1) / g.Lb == g.G && g.lpt == lanes_per_thread(g.Lb) &&
         block_fits(g.Lb, rows, smem) && smem_of(g, rows, l_pad) <= smem;
}

}  // namespace

extern "C" {

// The forward's design for B pairs of rows of l_pad bytes on a band of K
// lanes with the given ring (D = max lookback + 1; e2 and two_piece for
// the I2/D2 rings), as a code: bits 0-1 the tier (0 block, 1 cluster, 2
// global), bit 2 the rows staged in shared memory, 3-7 the blocks a
// pair, 8-11 the lanes a thread, 12 and up the lanes a block.
// force -1 takes the table's choice, 2 the global design. *held (if not
// null): the clusters (blocks for G = 1) the card holds at once, or
// minus a CUDA error code. -1 where no design takes the shape.
int allwave_wf_batch_forward_design(int K, int B, int l_pad, int D, int e1, int e2,
                                    int two_piece, int force, int* held) {
  int n = 0;
  const int code = choose(K, B, l_pad, ring_rows(D, e1, e2, two_piece), two_piece, force, &n);
  if (held != nullptr) *held = n;
  return code;
}

// qs, ts (B, l_pad) uint8, l_pad a multiple of 8 and rows 8-byte
// aligned; qlens, tlens (B,) int32; ring (B, 5, D, K) int32 scratch for
// the global design (null for the others); hist_p (5, s_cap + 1, B, K)
// int32 when hist, else unused; scores (B,) int32; done (B,) uint8. D =
// max_lookback + 1; every lookback (x, e1, o1 + e1, and with two_piece
// e2, o2 + e2) must lie in 1 .. D - 1. design: the code
// allwave_wf_batch_forward_design gives.
int allwave_wf_batch_forward(const void* qs, const void* ts, const void* qlens,
                             const void* tlens, int B, int l_pad, int K, int s_cap, int D,
                             int x, int o1, int e1, int o2, int e2, int two_piece, int hist,
                             int design, void* ring, void* hist_p, void* scores, void* done,
                             void* stream) {
  if (B <= 0) return 0;
  const WfPen pen{x, o1 + e1, e1, o2 + e2, e2, two_piece ? min(o1, o2) : o1,
                  two_piece ? min(e1, e2) : e1};
  const auto lookback_ok = [D](int ds) { return ds >= 1 && ds < D; };
  const Design g = decode(design);
  if (K < 1 || l_pad < 8 || (l_pad & 7) || s_cap < 0 || design < 0 || !lookback_ok(x) ||
      !lookback_ok(pen.e1) || !lookback_ok(pen.o1e1) ||
      (two_piece && (!lookback_ok(pen.e2) || !lookback_ok(pen.o2e2))) || (hist && !hist_p) ||
      (g.tier == TIER_GLOBAL) != (ring != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q8 = static_cast<const uint8_t*>(qs);
  const auto* t8 = static_cast<const uint8_t*>(ts);
  const auto* ql = static_cast<const int*>(qlens);
  const auto* tl = static_cast<const int*>(tlens);
  auto* hp = static_cast<int*>(hist_p);
  auto* sc = static_cast<int*>(scores);
  auto* dn = static_cast<uint8_t*>(done);
  if (g.tier == TIER_GLOBAL) {
    const auto kernel =
        hist ? (two_piece ? wf_batch_global_kernel<true, true> : wf_batch_global_kernel<true, false>)
             : (two_piece ? wf_batch_global_kernel<false, true>
                          : wf_batch_global_kernel<false, false>);
    const int threads = min(kMaxThreads, (K + 31) / 32 * 32);
    kernel<<<B, threads, 0, st>>>(q8, t8, ql, tl, B, l_pad, K, s_cap, D, pen,
                                  static_cast<int*>(ring), hp, sc, dn);
    return (int)cudaGetLastError();
  }
  const Ring rg = ring_of(D, e1, e2, two_piece);
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (!launchable(g, K, rg.rows, l_pad, smem)) return (int)cudaErrorInvalidValue;
  const void* kern = ring_kernel_of(hist, two_piece, g.staged);
  e = set_attributes(kern, g, rg.rows, l_pad);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, rg.rows, l_pad, B, st, &attr);
#define AW_RING(H, T, S) \
  launch_ring<H, T, S>(cfg, q8, t8, ql, tl, B, l_pad, K, s_cap, g, rg, pen, hp, sc, dn)
#define AW_RING2(H, T) (g.staged ? AW_RING(H, T, true) : AW_RING(H, T, false))
  e = hist ? (two_piece ? AW_RING2(true, true) : AW_RING2(true, false))
           : (two_piece ? AW_RING2(false, true) : AW_RING2(false, false));
#undef AW_RING2
#undef AW_RING
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// m, i1, d1, i2, d2: the history planes, (S1, B, K) int32 each; scores,
// qlens, tlens (B,) int32; ops (B, run_cap) uint8 and lens (B, run_cap)
// int32, zeroed by the caller; nruns (B,) int32; overflow (B,) uint8;
// stats (2, B) int32 (steps and round trips a pair) or null. design 0:
// the walk, a warp a pair; 1: the first design, a thread a pair (for
// timing it beside the walk; it keeps no stats).
int allwave_wf_batch_traceback(const void* m, const void* i1, const void* d1, const void* i2,
                               const void* d2, const void* scores, const void* qlens,
                               const void* tlens, int S1, int B, int K, int x, int o1, int e1,
                               int o2, int e2, int run_cap, int design, void* ops, void* lens,
                               void* nruns, void* overflow, void* stats, void* stream) {
  if (B <= 0) return 0;
  if (S1 < 1 || K < 1 || run_cap < 1 || design < 0 || design > 1 ||
      (design == 1 && stats != nullptr))
    return (int)cudaErrorInvalidValue;
  const WfPen pen{x, o1 + e1, e1, o2 + e2, e2, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    wf_batch_walk_kernel<<<(B + WALK_WARPS - 1) / WALK_WARPS, 32 * WALK_WARPS, 0, st>>>(
        static_cast<const int*>(m), static_cast<const int*>(i1), static_cast<const int*>(d1),
        static_cast<const int*>(i2), static_cast<const int*>(d2), static_cast<const int*>(scores),
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), S1, B, K, pen, run_cap,
        static_cast<uint8_t*>(ops), static_cast<int*>(lens), static_cast<int*>(nruns),
        static_cast<uint8_t*>(overflow), static_cast<int*>(stats));
  } else {
    wf_batch_thread_kernel<<<(B + kTbThreads - 1) / kTbThreads, kTbThreads, 0, st>>>(
        static_cast<const int*>(m), static_cast<const int*>(i1), static_cast<const int*>(d1),
        static_cast<const int*>(i2), static_cast<const int*>(d2), static_cast<const int*>(scores),
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), S1, B, K, pen, run_cap,
        static_cast<uint8_t*>(ops), static_cast<int*>(lens), static_cast<int*>(nruns),
        static_cast<uint8_t*>(overflow));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
