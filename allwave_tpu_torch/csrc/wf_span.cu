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
// What bounds it on an H100: a sweep is a chain of dependent score
// levels per pair, each a few dozen integer ops per band lane, one block
// barrier, and a greedy match-run extension whose length is data
// dependent (hundreds of bases between SNPs at 0.25% divergence, so the
// lanes of a warp diverge). A long-pair group has few pairs (10-36 at
// 100 kb), so only B of the 132 SMs work.
//
// Design: one block per pair, threads strided over the band's W
// diagonals. Each component keeps a ring of its last depth[c] score
// planes (the reference's comp_depths), all P planes in shared memory
// when they fit (SMEM_MAX_RING_BYTES in wfa/wf_segmented.py) and in a
// per-pair global scratch otherwise (576 KiB a pair at K = 4096, which
// stays in L2 for a 36-pair group). Level s writes slot s % depth[c];
// every lookback is >= 1 and < depth[c], so no read of level s touches
// the slot it writes and one barrier per level suffices; that barrier
// is a __syncthreads_or that also carries the pair's done flag. The
// extension compares the bases directly, 8 at a time (XOR and
// count-trailing-zeros) instead of the reference's mismatch bitmap; its
// offsets equal `_extend_bm`'s: the first stop at or after
// clip(h, 0, l_pad-1), where a stop is a mismatch or v < 0, v >= qlen,
// h >= tlen, or l_pad if none, capped at h_max. The checkpoint tensor
// comes in filled with NULL, so a pair that stops early leaves NULL in
// its later slots.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_NULL (-(1 << 30))

namespace {

struct WfPen {
  int x, o1e1, e1, o2e2, e2;
  int off[5], dep[5];
  int P;
};

enum { CM = 0, CI1 = 1, CD1 = 2, CI2 = 3, CD2 = 4 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 8 bytes of a row from byte idx on (rows are 8-byte aligned, l_pad a
// multiple of 32); bytes past l_pad read as 0
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

__device__ int extend(int h, int hmax, int k, const uint8_t* q,
                      const uint8_t* t, int qlen, int tlen, int l_pad) {
  if (!(h > AW_NULL && h <= hmax)) return h;
  int p = clampi(h, 0, l_pad - 1);
  const int lo = k > 0 ? k : 0;                      // v >= 0
  const int hi = tlen < qlen + k ? tlen : qlen + k;  // v < qlen, h < tlen
  int pos = p;
  if (p >= lo && p < hi) {
    pos = hi;  // no mismatch below hi: the range stop at hi (or l_pad)
    int v = p - k;
    while (p < hi) {
      const int n = hi - p < 8 ? hi - p : 8;
      const uint64_t x = load8(q, v, l_pad) ^ load8(t, p, l_pad);
      if (x != 0) {
        const int i = (__ffsll((long long)x) - 1) >> 3;
        if (i < n) {
          pos = p + i;
          break;
        }
      }
      p += n;
      v += n;
    }
  }
  return pos < hmax ? pos : hmax;
}

template <bool HIST>
__global__ void wf_span_kernel(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ c_lo, int B, int l_pad, int K, int W, int s_lo,
    int n_steps, int ckpt_every, WfPen pen, const int* __restrict__ ring_in,
    int* __restrict__ ckpts, int* __restrict__ hist,
    const uint8_t* __restrict__ done_in, const int* __restrict__ scores_in,
    uint8_t* __restrict__ done_out, int* __restrict__ scores_out,
    int* gscratch) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const uint8_t* q = qs + (size_t)b * l_pad;
  const uint8_t* t = ts + (size_t)b * l_pad;
  const int P = pen.P;

  // band geometry of the full band K (batch.py _band_geometry, k0 not
  // even-aligned), then the window [col0, col0 + W) of it
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  const int k0full = (k_end < 0 ? k_end : 0) - ((K - 1 - abs_kend) >> 1);
  const int col0 = c_lo == nullptr ? 0 : clampi(c_lo[b], 0, K - W);
  const int k0 = k0full + col0;
  const int c_end = clampi(k_end - k0full, 0, K - 1);
  const bool feasible = abs_kend <= K - 1;

  int* ring = gscratch != nullptr ? gscratch + (size_t)b * P * W : smem;
  const size_t img = (size_t)B * K;  // one plane of a ring image
  for (int pl = 0; pl < P; ++pl)
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const int v = ring_in[pl * img + (size_t)b * K + col0 + c];
      ring[pl * W + c] = v;
      if (!HIST) ckpts[pl * img + (size_t)b * K + c] = v;  // slot 0
    }
  bool done = !HIST && done_in[b] != 0;
  int score = HIST ? -1 : scores_in[b];
  __syncthreads();

#define RING(comp, sc, col) \
  ring[(pen.off[comp] + (sc) % pen.dep[comp]) * W + (col)]
  // component plane at score s - ds, column col; NULL outside
  auto at = [&](int comp, int s, int ds, int col) -> int {
    if (s < ds || col < 0 || col >= W) return AW_NULL;
    return RING(comp, s - ds, col);
  };

  for (int j = 0; j < n_steps; ++j) {
    if (!HIST && done) break;
    const int s = s_lo + 1 + j;
    if (!HIST && j > 0 && j % ckpt_every == 0) {
      // the ring at score s - 1, own lanes only: this thread overwrites
      // them below, after the copy
      int* slot = ckpts + (size_t)(j / ckpt_every) * P * img + (size_t)b * K;
      for (int pl = 0; pl < P; ++pl)
        for (int c = threadIdx.x; c < W; c += blockDim.x)
          slot[pl * img + c] = ring[pl * W + c];
    }
    int done_now = 0;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const int k = k0 + c;
      const int hm = (k >= -qlen && k <= tlen) ? min(tlen, qlen + k) : -1;
      const int i1s = max(at(CM, s, pen.o1e1, c - 1), at(CI1, s, pen.e1, c - 1));
      int i1 = i1s > AW_NULL ? i1s + 1 : AW_NULL;
      if (i1 > hm) i1 = AW_NULL;
      int d1 = max(at(CM, s, pen.o1e1, c + 1), at(CD1, s, pen.e1, c + 1));
      if (d1 > hm) d1 = AW_NULL;
      int best = max(i1, d1);
      int i2 = AW_NULL, d2 = AW_NULL;
      if (pen.o2e2 > 0) {  // two-piece
        const int i2s =
            max(at(CM, s, pen.o2e2, c - 1), at(CI2, s, pen.e2, c - 1));
        i2 = i2s > AW_NULL ? i2s + 1 : AW_NULL;
        if (i2 > hm) i2 = AW_NULL;
        d2 = max(at(CM, s, pen.o2e2, c + 1), at(CD2, s, pen.e2, c + 1));
        if (d2 > hm) d2 = AW_NULL;
        best = max(best, max(i2, d2));
      }
      int mis = at(CM, s, pen.x, c);
      mis = mis > AW_NULL ? mis + 1 : AW_NULL;
      if (mis > hm) mis = AW_NULL;
      int m = extend(max(best, mis), hm, k, q, t, qlen, tlen, l_pad);
      if (m > hm) m = AW_NULL;

      RING(CM, s, c) = m;
      RING(CI1, s, c) = i1;
      RING(CD1, s, c) = d1;
      RING(CI2, s, c) = i2;
      RING(CD2, s, c) = d2;
      if (HIST) {
        int* row = hist + (size_t)j * 5 * B * W + (size_t)b * W + c;
        const size_t cs = (size_t)B * W;
        row[0] = m;
        row[cs] = i1;
        row[2 * cs] = d1;
        row[3 * cs] = i2;
        row[4 * cs] = d2;
      } else if (c == c_end && m == tlen && feasible) {
        done_now = 1;
      }
    }
    // the level's barrier, and the pair's done flag to every thread
    if (__syncthreads_or(done_now) && !HIST) {
      done = true;
      score = s;
    }
  }
#undef RING
  if (!HIST && threadIdx.x == 0) {
    done_out[b] = done ? 1 : 0;
    scores_out[b] = score;
  }
}

}  // namespace

extern "C" {

// ring_in: (P, B, K) int32 ring image at s_lo. Sweep (ckpt_every > 0):
// ckpts (n_steps / ckpt_every, P, B, K), pre-filled with NULL; done_in,
// done_out (B,) bool; scores_in, scores_out (B,) int32. History
// (ckpt_every == 0): hist (n_steps, 5, B, W) int32; c_lo may be null (W
// == K). scratch (B, P, W) int32 is null when the ring fits in shared
// memory. o2e2 passes as 0 for one-piece penalties.
int allwave_wf_span(const void* qs, const void* ts, const void* qlens,
                    const void* tlens, const void* c_lo, int B, int l_pad,
                    int K, int W, int s_lo, int n_steps, int ckpt_every, int x,
                    int o1, int e1, int o2, int e2, int two_piece, int off0,
                    int off1, int off2, int off3, int off4, int dep0,
                    int dep1, int dep2, int dep3, int dep4, int P,
                    const void* ring_in, void* ckpts, void* hist,
                    const void* done_in, const void* scores_in,
                    void* done_out, void* scores_out, void* scratch,
                    void* stream) {
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
  const int threads = W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  const int smem = scratch == nullptr ? 4 * P * W : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AW_ARGS                                                              \
  static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),          \
      static_cast<const int*>(qlens), static_cast<const int*>(tlens),        \
      static_cast<const int*>(c_lo), B, l_pad, K, W, s_lo, n_steps,          \
      ckpt_every, pen, static_cast<const int*>(ring_in),                     \
      static_cast<int*>(ckpts), static_cast<int*>(hist),                     \
      static_cast<const uint8_t*>(done_in),                                  \
      static_cast<const int*>(scores_in), static_cast<uint8_t*>(done_out),   \
      static_cast<int*>(scores_out), static_cast<int*>(scratch)
  if (ckpt_every == 0) {
    cudaFuncSetAttribute(wf_span_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wf_span_kernel<true><<<B, threads, smem, st>>>(AW_ARGS);
  } else {
    cudaFuncSetAttribute(wf_span_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wf_span_kernel<false><<<B, threads, smem, st>>>(AW_ARGS);
  }
#undef AW_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
