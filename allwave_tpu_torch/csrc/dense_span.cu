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
// lane and a barrier. The long path's sweep runs few pairs (12 at
// 100 kb) on very wide bands (K up to 24576), so the time is the chain
// of steps, each as long as the lanes one SM walks plus its barrier;
// the replay adds one 2-byte plane store per lane and step.
//
// Two designs, chosen in one place (`choose` below, exported as
// allwave_dense_span_design):
//
// * The sweep (no planes): `dense_sweep_cluster_kernel`, one
//   thread-block cluster of G blocks a pair, block r owning the
//   window's lanes [r Lb, min((r+1) Lb, W)), Lb even, at least 1024
//   lanes a block; G <= 16 where the card holds every pair's cluster at
//   once (above 8 a cluster size is non-portable), else G <= 8. A block keeps its
//   lanes' five bands parity-packed in shared memory, [band][even lanes
//   | odd lanes], updated in place: step d moves only the lanes of d's
//   parity, which read the other parity's S, I1, I2 at k - 1 and S, D1,
//   D2 at k + 1 (written at d - 1) and their own S (from d - 2). Writing
//   no plane, it computes no lane of the wrong parity and copies
//   nothing. A block's edge lanes read the neighbour block's edge lane
//   over distributed shared memory. One cluster barrier a step orders
//   this step's writes before the next step's reads and its reads
//   before the next step's writes; its release fence is restricted to
//   the block's own shared memory, the only memory a step writes. The
//   bases are two tables of the clamped bytes the plain version reads,
//   indexed by v and by h, staged in shared memory for each stretch of
//   SW_STRETCH steps. G = 1 is an ordinary block with a block barrier.
// * The replay (planes): `dense_span_kernel`, one block a pair; lanes
//   strided over up to 1024 threads; the five int32 bands and the
//   run-length band double-buffered (one barrier per step) in shared
//   memory up to SPAN_SMEM_MAX bytes and in a per-pair global scratch
//   above. Bases are read as q[v-1] and t[h-1] at the clamped indices
//   the XLA span's shift registers hold, so every plane byte --
//   reachable or not -- equals the plain version's.
//
// Both take the state from a checkpoint slice, optionally at a per-pair
// column offset c_lo into a wider band (the narrow replay: origin
// k0 + c_lo, INF inflow at the window's edges), and write the state out
// straight to its slot (the next checkpoint, in the sweep). Offsets into
// states and planes are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace cg = cooperative_groups;

namespace {

constexpr int SPAN_SMEM_MAX = 200 * 1024;  // replay: bands in shared memory
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int SW_PORTABLE_G = 8;  // the portable cluster size
constexpr int SW_MAX_G = 16;      // the largest (non-portable) cluster
constexpr int SW_MIN_LB = 1024;   // lanes a block before a band spreads
constexpr int SW_STRETCH = 4096;  // steps one staging of the base tables covers

struct Pen {
  int x, o1e1, e1, o2e2, e2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The sweep's step barrier across a cluster: each thread's release fence
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

// ---------------------------------------------------------------------
// the sweep: a cluster a pair, parity-packed bands in shared memory

// bytes of each base table: every v (and h) a block of Lb lanes reads
// over SW_STRETCH steps
__host__ __device__ constexpr int sweep_table_bytes(int Lb) {
  return ((SW_STRETCH + Lb) / 2 + 2 + 15) / 16 * 16;
}

__host__ __device__ constexpr int sweep_smem_bytes(int Lb) {
  return 20 * Lb + 2 * sweep_table_bytes(Lb);
}

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

  // the base tables: qt[i] and tt[i] hold the bytes the plain version
  // reads at v = vmin + i and h = hmin + i, for every lane of the block
  // and every step of the stretch from d_a
  int vmin = 0, hmin = 0;
  auto stage = [&](int d_a) {
    vmin = (d_a - kb - (Lb - 1)) >> 1;
    hmin = (d_a + kb) >> 1;
    for (int i = tid; i < tbl; i += nt) {
      const int qi = clampi(qlen - (vmin + i), 0, l_pad - 1);
      qt[i] = q[clampi(qlen - 1 - qi, 0, l_pad - 1)];
      tt[i] = t[clampi(hmin + i - 1, 0, l_pad - 1)];
    }
  };
  stage(d_lo + 1);
  // every block of the cluster has started and loaded its lanes and
  // tables before any neighbour reads them
  if (G > 1) cluster.sync(); else __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int d = d_lo + 1 + s;
    if (s > 0 && s % SW_STRETCH == 0) {
      stage(d);  // the last step's barrier: no thread reads the old tables
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
// the replay: one block a pair, bands double-buffered, planes

template <bool TWO_PIECE, bool PLANES>
__global__ void dense_span_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ c_lo, int B, int l_pad, int K, int W, int d_lo,
    int n_steps, Pen pen, const int* __restrict__ state_in,
    long long in_band_stride, int* __restrict__ state_out,
    long long out_band_stride, uint16_t* __restrict__ planes, int* iscratch,
    uint8_t* rscratch) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;

  // band geometry of the full band K (dense.py _band_geometry), then the
  // window [col0, col0 + W) of it
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  int k0 = min(0, k_end) - ((K - 1 - abs_kend) >> 1);
  k0 -= (k0 & 1);
  const int col0 = c_lo == nullptr ? 0 : clampi(c_lo[b], 0, K - W);
  k0 += col0;

  // bands: [buf][band][W] int32 (S, I1, D1, I2, D2) + [buf][W] run length
  int* ib;
  uint8_t* rb;
  if (iscratch != nullptr) {
    ib = iscratch + (size_t)b * 10 * W;
    rb = rscratch + (size_t)b * 2 * W;
  } else {
    ib = smem;
    rb = reinterpret_cast<uint8_t*>(smem + 10 * W);
  }
#define BAND(buf, band) (ib + ((buf) * 5 + (band)) * W)

  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const size_t src = (size_t)b * K + col0 + c;
    for (int band = 0; band < 5; ++band)
      BAND(0, band)[c] = state_in[band * in_band_stride + src];
    if (PLANES) rb[c] = 0;
  }
  __syncthreads();

  const size_t plane_stride = (size_t)B * W;
  uint16_t* prow = PLANES ? planes + (size_t)b * W : nullptr;
  for (int i = 0; i < n_steps; ++i) {
    const int d = d_lo + 1 + i;
    const int pb = i & 1;
    const int nb = pb ^ 1;
    const int* S = BAND(pb, 0);
    const int* I1 = BAND(pb, 1);
    const int* D1 = BAND(pb, 2);
    const int* I2 = BAND(pb, 3);
    const int* Dd2 = BAND(pb, 4);
    const uint8_t* R = rb + pb * W;
    int* So = BAND(nb, 0);
    int* I1o = BAND(nb, 1);
    int* D1o = BAND(nb, 2);
    int* I2o = BAND(nb, 3);
    int* D2o = BAND(nb, 4);
    uint8_t* Ro = rb + nb * W;

    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const int k = k0 + c;
      const int v = (d - k) >> 1;
      const int h = (d + k) >> 1;
      const bool active = ((d - k) & 1) == 0 && v >= 0 && v <= qlen &&
                          h >= 0 && h <= tlen;

      const int s_prev = S[c];
      const int s_km1 = c > 0 ? S[c - 1] : AW_INF;
      const int s_kp1 = c < W - 1 ? S[c + 1] : AW_INF;

      const int i1_ext_v = (c > 0 ? I1[c - 1] : AW_INF) + pen.e1;
      const int i1_opn_v = s_km1 + pen.o1e1;
      const int i1_new = min(i1_opn_v, i1_ext_v);
      const int d1_ext_v = (c < W - 1 ? D1[c + 1] : AW_INF) + pen.e1;
      const int d1_opn_v = s_kp1 + pen.o1e1;
      const int d1_new = min(d1_opn_v, d1_ext_v);
      int best_gap = min(i1_new, d1_new);

      int i2_new = I2[c], d2_new = Dd2[c], i2_ext = 0, d2_ext = 0;
      if (TWO_PIECE) {
        const int i2_ext_v = (c > 0 ? I2[c - 1] : AW_INF) + pen.e2;
        const int i2_opn_v = s_km1 + pen.o2e2;
        i2_new = min(i2_opn_v, i2_ext_v);
        i2_ext = i2_ext_v <= i2_opn_v;
        const int d2_ext_v = (c < W - 1 ? Dd2[c + 1] : AW_INF) + pen.e2;
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

      int run_out = 0;
      if (PLANES) {
        // last write wins: D2 < D1 < I2 < I1 < diag-mismatch
        int choice = 0;
        if (TWO_PIECE && d2_new == s_new) choice = 5;
        if (d1_new == s_new) choice = 4;
        if (TWO_PIECE && i2_new == s_new) choice = 3;
        if (i1_new == s_new) choice = 2;
        if (diag_ok && diag == s_new && !is_match) choice = 1;
        const int packed = choice | ((i1_ext_v <= i1_opn_v) << 3) |
                           ((d1_ext_v <= d1_opn_v) << 4) | (i2_ext << 5) |
                           (d2_ext << 6);
        const int run_prev = R[c];
        const int new_run = choice == 0 ? min(run_prev, 254) + 1 : 0;
        prow[(size_t)i * plane_stride + c] = (uint16_t)(packed | (new_run << 8));
        run_out = active ? new_run : run_prev;
      }

      if (active) {
        So[c] = min(s_new, AW_INF);
        I1o[c] = min(i1_new, AW_INF);
        D1o[c] = min(d1_new, AW_INF);
        I2o[c] = min(i2_new, AW_INF);
        D2o[c] = min(d2_new, AW_INF);
      } else {
        So[c] = s_prev;
        I1o[c] = I1[c];
        D1o[c] = D1[c];
        I2o[c] = I2[c];
        D2o[c] = Dd2[c];
      }
      if (PLANES) Ro[c] = (uint8_t)run_out;
    }
    __syncthreads();
  }

  const int fb = n_steps & 1;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const size_t dst = (size_t)b * W + c;
    for (int band = 0; band < 5; ++band)
      state_out[band * out_band_stride + dst] = BAND(fb, band)[c];
  }
#undef BAND
}

// ---------------------------------------------------------------------
// the dispatch

struct Design {
  int sweep;    // 1: the cluster sweep, 0: the replay kernel
  int G;        // blocks a pair (the sweep's cluster)
  int Lb;       // lanes a block (the sweep)
  int scratch;  // bands in the global scratch (the replay)
};

int encode(const Design& g) {
  return g.sweep | (g.G << 1) | (g.scratch << 6) | (g.Lb << 7);
}

// threads a sweep block: its widest half in even turns of at most 1024
int sweep_threads(int Lb) {
  const int half = Lb / 2;
  const int turns = (half + 1023) / 1024;
  const int per = (half + turns - 1) / turns;
  return (per + 31) / 32 * 32;
}

cudaLaunchConfig_t sweep_config(const Design& g, int B, cudaStream_t st,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * g.G);
  cfg.blockDim = dim3(sweep_threads(g.Lb));
  cfg.dynamicSmemBytes = sweep_smem_bytes(g.Lb);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

const void* sweep_kernel(int two_piece) {
  return two_piece ? (const void*)dense_sweep_cluster_kernel<true>
                   : (const void*)dense_sweep_cluster_kernel<false>;
}

// what a kernel launched in the sweep's shape g needs set first
cudaError_t sweep_attributes(const void* kern, const Design& g) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sweep_smem_bytes(g.Lb));
  if (e == cudaSuccess && g.G > SW_PORTABLE_G)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// clusters of the sweep's shape g the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code
int max_clusters(const Design& g, int two_piece) {
  const void* kern = sweep_kernel(two_piece);
  cudaError_t e = sweep_attributes(kern, g);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sweep_config(g, g.G, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// W lanes in at most maxg blocks of at least SW_MIN_LB lanes, Lb even
Design sweep_design(int W, int maxg) {
  const int G = min(maxg, (W + SW_MIN_LB - 1) / SW_MIN_LB);
  const int per = (W + G - 1) / G;
  const int Lb = per + (per & 1);
  return Design{1, (W + Lb - 1) / Lb, Lb, 0};
}

// The replay runs one block a pair. The sweep spreads a band over up to
// SW_MAX_G blocks where the card holds all B clusters at once, else over
// up to SW_PORTABLE_G (more of them fit at once), whichever fits shared
// memory. False for a window no design takes.
bool choose(int K, int W, int with_planes, int B, int two_piece, Design* g) {
  *g = Design{0, 1, 0, 0};
  if (W < 1 || W > K) return false;
  if (with_planes) {
    g->Lb = W;
    g->scratch = 42 * W > SPAN_SMEM_MAX;
    return true;
  }
  const Design wide = sweep_design(W, SW_MAX_G);
  const Design portable = sweep_design(W, SW_PORTABLE_G);
  const bool wide_fits = sweep_smem_bytes(wide.Lb) <= SMEM_LIMIT;
  if (wide.G > SW_PORTABLE_G && wide_fits && max_clusters(wide, two_piece) >= B)
    *g = wide;
  else if (sweep_smem_bytes(portable.Lb) <= SMEM_LIMIT)
    *g = portable;
  else if (wide_fits)
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
  cudaError_t e = sweep_attributes((const void*)kern, g);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sweep_config(g, B, st, &attr);
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

template <bool TWO_PIECE>
int launch_replay(const Design& g, const void* qs, const void* ts,
                  const void* qlens, const void* tlens, const void* c_lo,
                  int B, int l_pad, int K, int W, int d_lo, int n_steps,
                  Pen pen, const void* state_in, long long in_stride,
                  void* state_out, long long out_stride, void* planes,
                  void* iscratch, void* rscratch, cudaStream_t st) {
  const int threads = W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  const int smem = g.scratch ? 0 : 42 * W;
  cudaFuncSetAttribute(dense_span_kernel<TWO_PIECE, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dense_span_kernel<TWO_PIECE, true><<<B, threads, smem, st>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
      static_cast<const int*>(qlens), static_cast<const int*>(tlens),
      static_cast<const int*>(c_lo), B, l_pad, K, W, d_lo, n_steps, pen,
      static_cast<const int*>(state_in), in_stride,
      static_cast<int*>(state_out), out_stride,
      static_cast<uint16_t*>(planes), static_cast<int*>(iscratch),
      static_cast<uint8_t*>(rscratch));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The design a span over a window of W lanes of a band K runs for B
// pairs, as a code: bit 0 the cluster sweep (with_planes 0) or the
// replay kernel (with_planes 1), bits 1-5 the sweep's blocks a pair G,
// bit 6 the replay's bands in the global scratch (the wrapper allocates
// it), bits 7 and up the sweep's lanes a block Lb. -1 for a window no
// design takes.
int allwave_dense_span_design(int K, int W, int with_planes, int B,
                              int two_piece) {
  Design g;
  if (!choose(K, W, with_planes, B, two_piece, &g)) return -1;
  return encode(g);
}

// The most clusters of the sweep's design for B pairs at (K, W) the card
// can hold at once (cudaOccupancyMaxActiveClusters), or minus a CUDA
// error code.
int allwave_dense_sweep_max_clusters(int K, int W, int B, int two_piece) {
  Design g;
  if (!choose(K, W, 0, B, two_piece, &g)) return -(int)cudaErrorInvalidValue;
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
  cudaError_t e = sweep_attributes((const void*)sweep_barrier_kernel, g);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      sweep_config(g, B, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, sweep_barrier_kernel, g.G, n_steps, full_fence,
                         static_cast<int*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// state_in / state_out: five (B, K) / (B, W) int32 bands, band i at
// element offset i * (in|out)_band_stride; c_lo may be null (full band,
// W == K); design: the code allwave_dense_span_design gives for (K, W,
// with_planes, B, two_piece); planes (n_steps, B, W) uint16, written
// when with_planes. iscratch (B, 10, W) int32 and rscratch (B, 2, W)
// uint8 where the design's bit 6 is set, else null.
int allwave_dense_span(const void* qs, const void* ts, const void* qlens,
                       const void* tlens, const void* c_lo, int B, int l_pad,
                       int K, int W, int d_lo, int n_steps, int x, int o1,
                       int e1, int o2, int e2, int two_piece,
                       int with_planes, int design, const void* state_in,
                       long long in_band_stride, void* state_out,
                       long long out_band_stride, void* planes,
                       void* iscratch, void* rscratch, void* stream) {
  Pen pen;
  pen.x = x;
  pen.e1 = e1;
  pen.e2 = e2;
  pen.o1e1 = o1 + e1;
  pen.o2e2 = two_piece ? o2 + e2 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Design g;
  if (!choose(K, W, with_planes, B, two_piece, &g) || encode(g) != design ||
      (g.scratch != 0) != (iscratch != nullptr) ||
      (iscratch != nullptr) != (rscratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (g.sweep) {
    return two_piece
               ? launch_sweep<true>(g, qs, ts, qlens, tlens, c_lo, B, l_pad, K,
                                    W, d_lo, n_steps, pen, state_in,
                                    in_band_stride, state_out, out_band_stride, st)
               : launch_sweep<false>(g, qs, ts, qlens, tlens, c_lo, B, l_pad,
                                     K, W, d_lo, n_steps, pen, state_in,
                                     in_band_stride, state_out, out_band_stride,
                                     st);
  }
  return two_piece
             ? launch_replay<true>(g, qs, ts, qlens, tlens, c_lo, B, l_pad, K,
                                   W, d_lo, n_steps, pen, state_in,
                                   in_band_stride, state_out, out_band_stride,
                                   planes, iscratch, rscratch, st)
             : launch_replay<false>(g, qs, ts, qlens, tlens, c_lo, B, l_pad, K,
                                    W, d_lo, n_steps, pen, state_in,
                                    in_band_stride, state_out, out_band_stride,
                                    planes, iscratch, rscratch, st);
}

}  // extern "C"
