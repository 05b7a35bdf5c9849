// One span of the wavefront (WFA) score sweep of the wavefront
// checkpoint-replay engine: score levels s_lo+1 .. s_lo+n_steps from a
// ring image, either as the sweep (scores only, a checkpoint of the ring
// every ckpt_every levels, each pair stopping once it is done) or as a
// replay (every level, the five component planes of each level out).
//
// Replaces: allwave_tpu/wfa/pallas_wf.py `_call_kernel` (kernel
// `_wf_kernel`), reached through `wf_sweep_pallas` and
// `wf_hist_span_pallas`, and the narrow sub-band replay of
// wf_segmented.py `wf_replay_tb_narrow`. Its plain twin is
// allwave_tpu_torch/wfa/wf_segmented.py `wf_span_ref`.
//
// What bounds it on an H100: a span is a chain of dependent score
// levels per pair, each a few dozen integer ops per band lane, one
// barrier, and a greedy match-run extension whose length is data
// dependent (hundreds of bases between SNPs at 0.25% divergence, on the
// few diagonals near the optimal path). A long-pair group has few pairs
// (4-36 at 100 kb), so the time is the chain of levels, each as long as
// the lanes one SM walks, its longest extension and the barrier.
//
// Design: a thread-block cluster of G blocks a pair (`choose` below,
// exported as allwave_wf_span_design, the one dispatch table). Block r
// owns the window's lanes [r Lb, min((r+1) Lb, W)), only the last block
// short; each thread holds lpt lanes, strided by the block size. G =
// ceil(W / WF_MIN_LB) up to 16 (above 8 a cluster size is non-portable)
// or up to 8, and 1-2 lanes a thread or up to 4 times more (fewer
// registers a block), whichever lets the most of a batch's clusters
// run at once; G = 1 is an ordinary block with a block barrier.
//
// * Rings in shared memory. Each component keeps a ring of its last
//   depth[c] score planes (the reference's comp_depths); a block holds
//   its lanes of all P planes, [plane][lane], plus one plane of NULLs
//   that a read of a score below 0 points at. Level s writes slot
//   s % depth[c]; every lookback is >= 1 and < depth[c], so no read of
//   level s touches the slot it writes, and one barrier a level orders
//   every write before the next level's reads.
// * Slot indices once a level: the write slot of each component is kept
//   incrementally (slot + 1 == depth ? 0 : slot + 1) and each read
//   plane (M at s - x, s - o1 - e1, s - o2 - e2; I1/D1 at s - e1; I2/D2
//   at s - e2) follows from it by one subtraction and wrap, as a
//   uniform value: no lane divides.
// * Neighbours over distributed shared memory, no remote stores: lane c
//   reads lanes c - 1 and c + 1 only at older levels, so a block's edge
//   lane reads the neighbour block's ring slot directly, after the
//   level's cluster barrier (dense_span.cu's `sweep_barrier`: a
//   release fence restricted to the block's shared memory, then a
//   relaxed arrive and a wait; cluster.sync() fences the whole GPU and
//   costs ~5x more).
// * A warp-cooperative extension: each lane first compares its own next
//   8 bases (XOR and find-first-set); most lanes stop there. The lanes
//   still matching are then extended one at a time by the whole warp,
//   32 threads x 8 bytes = 256 bases an iteration, the first stop found
//   by __ballot_sync and __ffs. Offsets equal `_extend_bm`'s: the first
//   stop at or after clip(h, 0, l_pad-1), a stop being a mismatch, v <
//   0, v >= qlen, h >= tlen, or l_pad if none, capped at h_max; no byte
//   at or past l_pad is compared.
// * Done and leaving together (sweep): the block holding c_end stamps a
//   flag in its shared memory with the level s it finished at; after the
//   barrier every block reads it there and stops if it reads s, so all
//   blocks leave the level loop at the same level, and pass one last
//   barrier before any exits. The stamp is what makes the read safe: the
//   barrier orders the level-s write before every read of level s, but
//   not a read of level s before a write of level s + 1, which a block
//   that has passed the barrier may already make. A reader delayed so
//   far reads s + 1, not s, so it goes on to level s + 1 with the rest;
//   no write of level s + 2 can come before its read, because that
//   needs its arrival at the level-(s + 1) barrier. The checkpoint tensor comes
//   in filled with NULL, so a pair that stops early leaves NULL in its
//   later slots; each block writes its own lanes of every slot. History
//   mode has no done tracking and writes the five planes of each level,
//   coalesced across a block's lanes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AW_NULL (-(1 << 30))

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int WF_PORTABLE_G = 8;   // the portable cluster size
constexpr int WF_MAX_G = 16;       // the largest (non-portable) cluster
constexpr int WF_MIN_LB = 256;     // lanes a block before a window spreads
constexpr int WF_THREADS = 512;    // the most threads a block
constexpr int WF_MAX_LB = 4096;    // the most lanes a block (8 a thread)

struct WfPen {
  int x, o1e1, e1, o2e2, e2;
  int off[5], dep[5];
  int P;
};

enum { CM = 0, CI1 = 1, CD1 = 2, CI2 = 3, CD2 = 4 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The level barrier across a cluster (as dense_span.cu's): each thread's
// release fence restricted to its own block's shared memory, a relaxed
// arrive and an acquiring wait.
__device__ __forceinline__ void sweep_barrier() {
  asm volatile(
      "fence.release.sync_restrict::shared::cta.cluster;\n"
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 8 bytes of a row from byte idx on (rows are 8-byte aligned, l_pad a
// multiple of 32, idx < l_pad); bytes past l_pad read as 0
__device__ __forceinline__ uint64_t load8(const uint8_t* row, int idx,
                                          int l_pad) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(row);
  const int wi = idx >> 3;
  const int sh = (idx & 7) * 8;
  const uint64_t lo = w[wi];
  if (sh == 0) return lo;
  const uint64_t hi = (wi + 1) * 8 < l_pad ? w[wi + 1] : 0ull;
  return (lo >> sh) | (hi << (64 - sh));
}

// index of the first differing byte of q[v..v+n) and t[p..p+n) (n <= 8),
// or 8 if they are equal there
__device__ __forceinline__ int first_stop8(const uint8_t* q, const uint8_t* t,
                                           int v, int p, int n, int l_pad) {
  const uint64_t x = load8(q, v, l_pad) ^ load8(t, p, l_pad);
  const int i = x != 0 ? (__ffsll((long long)x) - 1) >> 3 : 8;
  return i < n ? i : 8;
}

// The match-run extension of every lane of a warp at one level, called
// by all 32 threads together. A thread whose lane is `act` with offset h
// (h_max hmax, diagonal k) gets the extended offset; other threads get h
// back. Lanes holding NULL or h > hmax pass through unchanged.
__device__ __forceinline__ int extend_warp(bool act, int h, int hmax, int k,
                                           const uint8_t* q, const uint8_t* t,
                                           int qlen, int tlen, int l_pad) {
  const bool ext = act && h > AW_NULL && h <= hmax;
  int pos = h, p = 0, hi = 0;
  bool pend = false;
  if (ext) {
    p = clampi(h, 0, l_pad - 1);
    const int lo = k > 0 ? k : 0;                // v >= 0
    hi = tlen < qlen + k ? tlen : qlen + k;      // v < qlen, h < tlen
    pos = p;                                     // p itself a stop
    if (p >= lo && p < hi) {
      const int n = hi - p < 8 ? hi - p : 8;
      const int i = first_stop8(q, t, p - k, p, n, l_pad);
      if (i < 8) {
        pos = p + i;
      } else if (hi - p <= 8) {
        pos = hi;  // no mismatch below hi: the range stop (or l_pad)
      } else {
        pend = true;
        p += 8;
      }
    }
  }
  // the lanes still matching, one at a time, by the whole warp
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(FULL, pend);
  while (todo != 0) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    int pp = __shfl_sync(FULL, p, src);
    const int kk = __shfl_sync(FULL, k, src);
    const int hh = __shfl_sync(FULL, hi, src);
    int found = hh;
    for (;;) {
      const int base = pp + 8 * lane;
      int i = 8;
      if (base < hh) {
        const int n = hh - base < 8 ? hh - base : 8;
        i = first_stop8(q, t, base - kk, base, n, l_pad);
      }
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
  return ext && pos > hmax ? hmax : pos;
}

// a ring slot `back` levels behind the write slot w of a ring of depth d
__device__ __forceinline__ int back_slot(int w, int back, int d) {
  const int r = w - back;
  return r < 0 ? r + d : r;
}

template <bool HIST, bool TWO_PIECE>
__global__ void __launch_bounds__(WF_THREADS, 1) wf_span_cluster_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ c_lo, int B, int l_pad, int K, int W, int s_lo,
    int n_steps, int ckpt_every, int G, int Lb, int lpt, WfPen pen,
    const int* __restrict__ ring_in, int* __restrict__ ckpts,
    int* __restrict__ hist, const uint8_t* __restrict__ done_in,
    const int* __restrict__ scores_in, uint8_t* __restrict__ done_out,
    int* __restrict__ scores_out) {
  extern __shared__ __align__(16) int smem[];  // [P + 1][Lb], then the flag
  cg::cluster_group cluster = cg::this_cluster();
  const int r = G > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;
  const int P = pen.P;

  // band geometry of the full band K (batch.py _band_geometry, k0 not
  // even-aligned), then the window [col0, col0 + W) of it, then this
  // block's lanes of it
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  const int k0full = (k_end < 0 ? k_end : 0) - ((K - 1 - abs_kend) >> 1);
  const int col0 = c_lo == nullptr ? 0 : clampi(c_lo[b], 0, K - W);
  const int c_first = r * Lb;
  const int n_r = min(Lb, W - c_first);  // lanes of this block, >= 1
  const int kb = k0full + col0 + c_first;  // k of lane c is kb + c
  const int c_end = clampi(k_end - k0full, 0, K - 1);
  const bool feasible = abs_kend <= K - 1;

  int* ring = smem;
  int* flag = smem + (P + 1) * Lb;
  const size_t img = (size_t)B * K;  // one plane of a ring image
  const size_t src0 = (size_t)b * K + col0 + c_first;
  // lanes are walked as thread tid's lanes tid + it nt, it < lpt: a
  // uniform trip count, where a strided loop to n_r would divide
  for (int it = 0; it < lpt; ++it) {
    const int c = tid + it * nt;
    if (c >= Lb) break;
    ring[P * Lb + c] = AW_NULL;
    if (c >= n_r) continue;
    for (int pl = 0; pl < P; ++pl) {
      const int v = ring_in[pl * img + src0 + c];
      if (!HIST) ckpts[pl * img + src0 + c] = v;  // slot 0 (col0 is 0)
      // one-piece I2 and D2 (depth 1, the last two planes) are never
      // read and are NULL from the first level on
      ring[pl * Lb + c] = (!TWO_PIECE && pl >= pen.off[CI2]) ? AW_NULL : v;
    }
  }
  if (tid == 0) *flag = AW_NULL;  // no level's stamp
  bool done = !HIST && done_in[b] != 0;
  int score = HIST ? -1 : scores_in[b];
  // the neighbours' rings (their edge lanes: the left block's last lane,
  // the right block's first), and the flag of the block holding c_end
  const int* left = nullptr;
  const int* right = nullptr;
  const volatile int* dflag = flag;
  if (G > 1) {
    if (r > 0) left = cluster.map_shared_rank(ring, r - 1) + (Lb - 1);
    if (r < G - 1) right = cluster.map_shared_rank(ring, r + 1);
    if (!HIST) dflag = cluster.map_shared_rank(flag, min(c_end / Lb, G - 1));
  }
  // this block's lane at c_end, if it holds it and the pair is feasible
  const int end_lane =
      !HIST && feasible && c_end >= c_first && c_end < c_first + n_r ? c_end - c_first : -1;
  // every block of the cluster has started and staged its ring before
  // any neighbour reads it
  if (G > 1) cluster.sync(); else __syncthreads();

  // the write slots of score s_lo + 1, then kept incrementally
  const int dm = pen.dep[CM], d1 = pen.dep[CI1], d2 = pen.dep[CI2];
  int wm = (s_lo + 1) % dm, w1 = (s_lo + 1) % d1, w2 = (s_lo + 1) % d2;
  int ck_left = ckpt_every;  // levels to the next checkpoint
  int* ck_slot = ckpts;
  const size_t hrow = (size_t)B * W;  // one history plane

  for (int j = 0; j < n_steps; ++j) {
    if (!HIST && done) break;
    const int s = s_lo + 1 + j;
    if (!HIST && ck_left == 0) {
      // the ring at score s - 1, own lanes only: this thread overwrites
      // them below, after the copy
      ck_slot += (size_t)P * img;
      ck_left = ckpt_every;
      for (int it = 0; it < lpt; ++it) {
        const int c = tid + it * nt;
        if (c >= n_r) break;
        for (int pl = 0; pl < P; ++pl) ck_slot[pl * img + src0 + c] = ring[pl * Lb + c];
      }
    }
    // the planes this level reads (the NULL plane P below score 0) and
    // writes, uniform across the cluster
    const int pmo1 = (s >= pen.o1e1 ? pen.off[CM] + back_slot(wm, pen.o1e1, dm) : P) * Lb;
    const int pmx = (s >= pen.x ? pen.off[CM] + back_slot(wm, pen.x, dm) : P) * Lb;
    const int s1 = back_slot(w1, pen.e1, d1);
    const int pi1 = (s >= pen.e1 ? pen.off[CI1] + s1 : P) * Lb;
    const int pd1 = (s >= pen.e1 ? pen.off[CD1] + s1 : P) * Lb;
    int pmo2 = 0, pi2 = 0, pd2 = 0;
    if (TWO_PIECE) {
      const int s2 = back_slot(w2, pen.e2, d2);
      pmo2 = (s >= pen.o2e2 ? pen.off[CM] + back_slot(wm, pen.o2e2, dm) : P) * Lb;
      pi2 = (s >= pen.e2 ? pen.off[CI2] + s2 : P) * Lb;
      pd2 = (s >= pen.e2 ? pen.off[CD2] + s2 : P) * Lb;
    }
    const int wM = (pen.off[CM] + wm) * Lb;
    const int wI1 = (pen.off[CI1] + w1) * Lb;
    const int wD1 = (pen.off[CD1] + w1) * Lb;
    const int wI2 = (pen.off[CI2] + w2) * Lb;
    const int wD2 = (pen.off[CD2] + w2) * Lb;

    bool done_now = false;
    for (int it = 0; it < lpt; ++it) {
      const int c = tid + it * nt;
      const bool in = c < n_r;
      const int k = kb + c;
      int hm = -1, i1 = AW_NULL, d1v = AW_NULL, i2 = AW_NULL, d2v = AW_NULL, h = AW_NULL;
      if (in) {
        hm = (k >= -qlen && k <= tlen) ? min(tlen, qlen + k) : -1;
        // lane c - 1: M and I1 (I2); lane c + 1: M and D1 (D2)
        int ml1 = AW_NULL, il1 = AW_NULL, ml2 = AW_NULL, il2 = AW_NULL;
        if (c > 0) {
          const int* a = ring + (c - 1);
          ml1 = a[pmo1];
          il1 = a[pi1];
          if (TWO_PIECE) {
            ml2 = a[pmo2];
            il2 = a[pi2];
          }
        } else if (left != nullptr) {
          ml1 = left[pmo1];
          il1 = left[pi1];
          if (TWO_PIECE) {
            ml2 = left[pmo2];
            il2 = left[pi2];
          }
        }
        int mr1 = AW_NULL, dr1 = AW_NULL, mr2 = AW_NULL, dr2 = AW_NULL;
        if (c + 1 < n_r) {
          const int* a = ring + (c + 1);
          mr1 = a[pmo1];
          dr1 = a[pd1];
          if (TWO_PIECE) {
            mr2 = a[pmo2];
            dr2 = a[pd2];
          }
        } else if (right != nullptr) {
          mr1 = right[pmo1];
          dr1 = right[pd1];
          if (TWO_PIECE) {
            mr2 = right[pmo2];
            dr2 = right[pd2];
          }
        }
        const int i1s = max(ml1, il1);
        i1 = i1s > AW_NULL ? i1s + 1 : AW_NULL;
        if (i1 > hm) i1 = AW_NULL;
        d1v = max(mr1, dr1);
        if (d1v > hm) d1v = AW_NULL;
        int best = max(i1, d1v);
        if (TWO_PIECE) {
          const int i2s = max(ml2, il2);
          i2 = i2s > AW_NULL ? i2s + 1 : AW_NULL;
          if (i2 > hm) i2 = AW_NULL;
          d2v = max(mr2, dr2);
          if (d2v > hm) d2v = AW_NULL;
          best = max(best, max(i2, d2v));
        }
        int mis = ring[pmx + c];
        mis = mis > AW_NULL ? mis + 1 : AW_NULL;
        if (mis > hm) mis = AW_NULL;
        h = max(best, mis);
      }
      int m = extend_warp(in, h, hm, k, q, t, qlen, tlen, l_pad);
      if (in) {
        if (m > hm) m = AW_NULL;
        ring[wM + c] = m;
        ring[wI1 + c] = i1;
        ring[wD1 + c] = d1v;
        if (TWO_PIECE) {
          ring[wI2 + c] = i2;
          ring[wD2 + c] = d2v;
        }
        if (HIST) {
          int* row = hist + (size_t)j * 5 * hrow + (size_t)b * W + c_first + c;
          row[0] = m;
          row[hrow] = i1;
          row[2 * hrow] = d1v;
          row[3 * hrow] = i2;
          row[4 * hrow] = d2v;
        } else if (c == end_lane && m == tlen) {
          done_now = true;
        }
      }
    }
    if (!HIST && done_now) *flag = s;
    // this level's writes before the next level's reads (the neighbours'
    // included) and its reads before the next level's writes
    if (G > 1) sweep_barrier(); else __syncthreads();
    if (!HIST && *dflag == s) {
      done = true;
      score = s;
    }
    wm = wm + 1 == dm ? 0 : wm + 1;
    w1 = w1 + 1 == d1 ? 0 : w1 + 1;
    w2 = w2 + 1 == d2 ? 0 : w2 + 1;
    --ck_left;
  }
  // no block exits while a neighbour may still read its ring or flag
  if (G > 1) sweep_barrier();
  if (!HIST && r == 0 && tid == 0) {
    done_out[b] = done ? 1 : 0;
    scores_out[b] = score;
  }
}

// ---------------------------------------------------------------------
// host side: the design, its launch shape and the launch

struct Design {
  int hist;  // history (1) or sweep (0)
  int G;     // blocks a pair (the cluster)
  int lpt;   // lanes a thread
  int Lb;    // lanes a block
};

int encode(const Design& g) { return g.hist | (g.G << 1) | (g.lpt << 6) | (g.Lb << 10); }

Design decode(int code) {
  return Design{code & 1, (code >> 1) & 31, (code >> 6) & 15, code >> 10};
}

int threads_of(const Design& g) { return ((g.Lb + g.lpt - 1) / g.lpt + 31) / 32 * 32; }

int smem_of(const Design& g, int P) { return 4 * ((P + 1) * g.Lb + 4); }

cudaLaunchConfig_t launch_config(const Design& g, int P, int B, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * g.G);
  cfg.blockDim = dim3(threads_of(g));
  cfg.dynamicSmemBytes = smem_of(g, P);
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
  if (g.hist)
    return two_piece ? (const void*)wf_span_cluster_kernel<true, true>
                     : (const void*)wf_span_cluster_kernel<true, false>;
  return two_piece ? (const void*)wf_span_cluster_kernel<false, true>
                   : (const void*)wf_span_cluster_kernel<false, false>;
}

// what a kernel launched in the shape of g needs set first
cudaError_t set_attributes(const void* kern, const Design& g, int P) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_of(g, P));
  if (e == cudaSuccess && g.G > WF_PORTABLE_G)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// clusters of design g the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code
int max_clusters(const Design& g, int two_piece, int P) {
  const void* kern = kernel_of(g, two_piece);
  cudaError_t e = set_attributes(kern, g, P);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, P, g.G, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// W lanes in at most maxg blocks of at least WF_MIN_LB lanes, more
// blocks where a block's ring would not fit in shared memory, as few
// lanes a thread as WF_THREADS allows; false if maxg blocks do not take
// it
bool span_design(int W, int P, int hist, int maxg, Design* g) {
  for (int G = min(maxg, (W + WF_MIN_LB - 1) / WF_MIN_LB); G <= maxg; ++G) {
    const int Lb = (W + G - 1) / G;
    const Design d{hist, (W + Lb - 1) / Lb, (Lb + WF_THREADS - 1) / WF_THREADS, Lb};
    if (Lb <= WF_MAX_LB && smem_of(d, P) <= SMEM_LIMIT) {
      *g = d;
      return true;
    }
  }
  return false;
}

// The span waits on each level's latency, so what costs is a batch whose
// clusters do not all fit on the card at once and run in waves. The
// candidates, in order: up to WF_MAX_G blocks a pair (above 8 a
// non-portable size), then up to WF_PORTABLE_G, each with 1, 2 and 4
// times the fewest lanes a thread (fewer threads and registers a block,
// so more blocks fit an SM). The first whose B clusters all fit at once
// (cudaOccupancyMaxActiveClusters) is taken, else the one with the
// fewest waves; *held is its clusters the card holds at once (or minus
// a CUDA error code). False for a window no design takes.
bool choose(int K, int W, int hist, int B, int two_piece, int P, Design* g, int* held) {
  *g = Design{hist, 1, 1, 0};
  *held = 0;
  if (W < 1 || W > K || P < 5) return false;
  Design base[2];
  int n_base = 0;
  if (span_design(W, P, hist, WF_MAX_G, &base[n_base])) ++n_base;
  if (span_design(W, P, hist, WF_PORTABLE_G, &base[n_base]) &&
      (n_base == 0 || base[n_base].G != base[0].G))
    ++n_base;
  if (n_base == 0) return false;
  long long best_waves = -1;
  for (int i = 0; i < n_base; ++i)
    for (int m = 1; m <= 4 && base[i].lpt * m <= 8; m *= 2) {
      Design d = base[i];
      d.lpt *= m;
      const int n = max_clusters(d, two_piece, P);
      const long long waves = n > 0 ? (B + n - 1) / n : (1LL << 40);
      if (best_waves < 0 || waves < best_waves) {
        *g = d;
        *held = n;
        best_waves = waves;
      }
      if (waves <= 1) return true;
    }
  return true;
}

// whether g is a design a span over W lanes of a band K may launch: its
// blocks cover the window, each within the block and shared-memory
// limits (what `choose` weighed to pick it is not redone per launch)
bool launchable(const Design& g, int K, int W, int hist, int P) {
  return W >= 1 && W <= K && P >= 5 && g.hist == hist && g.G >= 1 && g.G <= WF_MAX_G &&
         g.Lb >= 1 && g.Lb <= WF_MAX_LB && g.lpt >= 1 && (W + g.Lb - 1) / g.Lb == g.G &&
         threads_of(g) <= WF_THREADS && smem_of(g, P) <= SMEM_LIMIT;
}

template <bool HIST, bool TWO_PIECE>
int launch(const Design& g, const void* qs, const void* ts, const void* qlens,
           const void* tlens, const void* c_lo, int B, int l_pad, int K, int W,
           int s_lo, int n_steps, int ckpt_every, const WfPen& pen,
           const void* ring_in, void* ckpts, void* hist, const void* done_in,
           const void* scores_in, void* done_out, void* scores_out,
           cudaStream_t st) {
  auto* kern = wf_span_cluster_kernel<HIST, TWO_PIECE>;
  cudaError_t e = set_attributes((const void*)kern, g, pen.P);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, pen.P, B, st, &attr);
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
      static_cast<const int*>(qlens), static_cast<const int*>(tlens),
      static_cast<const int*>(c_lo), B, l_pad, K, W, s_lo, n_steps, ckpt_every, g.G,
      g.Lb, g.lpt, pen, static_cast<const int*>(ring_in), static_cast<int*>(ckpts),
      static_cast<int*>(hist), static_cast<const uint8_t*>(done_in),
      static_cast<const int*>(scores_in), static_cast<uint8_t*>(done_out),
      static_cast<int*>(scores_out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The design a span over a window of W lanes of a band K runs for B
// pairs with a ring of P planes, as a code: bit 0 history (hist 1) or
// sweep, bits 1-5 the blocks a pair G (the cluster), bits 6-9 the lanes
// a thread, bits 10 and up the lanes a block Lb. -1 for a window no
// design takes. *held (if not null) gets how many of the design's
// clusters the card holds at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error code.
int allwave_wf_span_design(int K, int W, int hist, int B, int two_piece, int P, int* held) {
  Design g;
  int n = 0;
  const bool ok = choose(K, W, hist != 0, B, two_piece, P, &g, &n);
  if (held != nullptr) *held = n;
  return ok ? encode(g) : -1;
}

// ring_in: (P, B, K) int32 ring image at s_lo. Sweep (ckpt_every > 0,
// c_lo null, W == K): ckpts (n_steps / ckpt_every, P, B, K), pre-filled
// with NULL; done_in, done_out (B,) bool; scores_in, scores_out (B,)
// int32. History (ckpt_every == 0): hist (n_steps, 5, B, W) int32; c_lo
// may be null (W == K). o2e2 passes as 0 for one-piece penalties.
// design: the code allwave_wf_span_design gives for (K, W, history, B,
// two_piece, P).
int allwave_wf_span(const void* qs, const void* ts, const void* qlens,
                    const void* tlens, const void* c_lo, int B, int l_pad,
                    int K, int W, int s_lo, int n_steps, int ckpt_every, int x,
                    int o1, int e1, int o2, int e2, int two_piece, int off0,
                    int off1, int off2, int off3, int off4, int dep0,
                    int dep1, int dep2, int dep3, int dep4, int P, int design,
                    const void* ring_in, void* ckpts, void* hist,
                    const void* done_in, const void* scores_in,
                    void* done_out, void* scores_out, void* stream) {
  const int hmode = ckpt_every == 0;
  const Design g = decode(design);
  if (design < 0 || !launchable(g, K, W, hmode, P) ||
      (hist != nullptr) != (hmode != 0) || (!hmode && (c_lo != nullptr || W != K)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  WfPen pen;
  pen.x = x;
  pen.o1e1 = o1 + e1;
  pen.e1 = e1;
  pen.o2e2 = two_piece ? o2 + e2 : 0;
  pen.e2 = e2;
  const int offs[5] = {off0, off1, off2, off3, off4};
  const int deps[5] = {dep0, dep1, dep2, dep3, dep4};
  for (int i = 0; i < 5; ++i) {
    pen.off[i] = offs[i];
    pen.dep[i] = deps[i];
  }
  pen.P = P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AW_LAUNCH(HIST, TWO)                                                     \
  launch<HIST, TWO>(g, qs, ts, qlens, tlens, c_lo, B, l_pad, K, W, s_lo, n_steps, \
                    ckpt_every, pen, ring_in, ckpts, hist, done_in, scores_in,   \
                    done_out, scores_out, st)
  if (hmode) return two_piece ? AW_LAUNCH(true, true) : AW_LAUNCH(true, false);
  return two_piece ? AW_LAUNCH(false, true) : AW_LAUNCH(false, false);
#undef AW_LAUNCH
}

}  // extern "C"
