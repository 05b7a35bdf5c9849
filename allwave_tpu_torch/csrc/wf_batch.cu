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
// one after another. The traceback: one walker a pair, each step a few
// dependent reads of planes far larger than L2; the bound is the chain
// of device-memory round trips, not bytes.
//
// Design (the simplest right one; shared memory for small bands and
// several blocks a pair are later work):
// * `wf_batch_forward_kernel<HIST, TWO_PIECE>`: one block a pair, up to
//   1024 threads, lanes c = threadIdx.x + i * blockDim.x. The D-slot
//   rolling buffer ([5][D][K] int32 a pair) lives in device memory, where
//   it stays L2-resident, so any band up to the reference's K = 32769
//   runs. The kernel loops over score levels with one __syncthreads() a
//   level: the slot a level writes is never one it reads (every lookback
//   is 1 .. D - 1), so the barrier after the writes is the only one. The
//   write slot advances by one compare a level; a read slot is one
//   subtraction and wrap behind (no division). The match extension
//   compares 8 bases at a time: two aligned 8-byte words a row, funnel-
//   shifted, the first differing byte by find-first-set. The lane that
//   holds the end diagonal stamps a shared flag with the level it
//   reached (tlen, k_end) at; a level's check after the barrier breaks
//   only on a stamp at or below it, so a thread that runs ahead to the
//   next level cannot end a slower one's level early. With HIST each
//   level's five planes go to hist ((5, s_cap + 1, B, K) int32), lanes
//   in a row coalesced; rows above a finished pair's score are left
//   unwritten (the port's don't-care rule, wfa/batch.py).
// * `wf_batch_traceback_kernel`: one thread a pair, 128 a block. It
//   walks from (scores[b], c_end, M) to the origin exactly as the XLA
//   body does for one lane: the M state's five candidates in the tie
//   order X, I1, I2, D1, D2, the gap states' extend before open, the M
//   run then the X emit, a run index clamped to run_cap - 1 while nrun
//   counts on, overflow once nrun >= run_cap, and a walker still active
//   after 3 * run_cap + 8 steps flagged as overflow. It reads nothing
//   above scores[b].

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define AW_NULL (-(1 << 30))

namespace {

constexpr int kComps = 5;  // m, i1, d1, i2, d2: the planes' order
constexpr int kMaxThreads = 1024;
constexpr int kTbThreads = 128;
constexpr int kCM = 0, kCI1 = 1, kCD1 = 2, kCI2 = 3, kCD2 = 4;

struct WfPen {
  int x, o1e1, e1, o2e2, e2;
};

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

template <bool HIST, bool TWO_PIECE>
__global__ void __launch_bounds__(kMaxThreads) wf_batch_forward_kernel(
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

__global__ void __launch_bounds__(kTbThreads) wf_batch_traceback_kernel(
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

}  // namespace

extern "C" {

// qs, ts (B, l_pad) uint8, l_pad a multiple of 8 and rows 8-byte
// aligned; qlens, tlens (B,) int32; ring (B, 5, D, K) int32 scratch;
// hist_p (5, s_cap + 1, B, K) int32 when hist, else unused; scores (B,)
// int32; done (B,) uint8. D = max_lookback + 1; every lookback (x, e1,
// o1 + e1, and with two_piece e2, o2 + e2) must lie in 1 .. D - 1.
int allwave_wf_batch_forward(const void* qs, const void* ts, const void* qlens,
                             const void* tlens, int B, int l_pad, int K, int s_cap, int D,
                             int x, int o1, int e1, int o2, int e2, int two_piece, int hist,
                             void* ring, void* hist_p, void* scores, void* done,
                             void* stream) {
  if (B <= 0) return 0;
  const WfPen pen{x, o1 + e1, e1, o2 + e2, e2};
  const auto lookback_ok = [D](int ds) { return ds >= 1 && ds < D; };
  if (K < 1 || l_pad < 8 || (l_pad & 7) || s_cap < 0 || !lookback_ok(x) ||
      !lookback_ok(pen.e1) || !lookback_ok(pen.o1e1) ||
      (two_piece && (!lookback_ok(pen.e2) || !lookback_ok(pen.o2e2))) || (hist && !hist_p))
    return (int)cudaErrorInvalidValue;
  const auto kernel =
      hist ? (two_piece ? wf_batch_forward_kernel<true, true> : wf_batch_forward_kernel<true, false>)
           : (two_piece ? wf_batch_forward_kernel<false, true>
                        : wf_batch_forward_kernel<false, false>);
  const int threads = min(kMaxThreads, (K + 31) / 32 * 32);
  kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
      static_cast<const int*>(qlens), static_cast<const int*>(tlens), B, l_pad, K, s_cap, D, pen,
      static_cast<int*>(ring), static_cast<int*>(hist_p), static_cast<int*>(scores),
      static_cast<uint8_t*>(done));
  return (int)cudaGetLastError();
}

// m, i1, d1, i2, d2: the history planes, (S1, B, K) int32 each; scores,
// qlens, tlens (B,) int32; ops (B, run_cap) uint8 and lens (B, run_cap)
// int32, zeroed by the caller; nruns (B,) int32; overflow (B,) uint8.
int allwave_wf_batch_traceback(const void* m, const void* i1, const void* d1, const void* i2,
                               const void* d2, const void* scores, const void* qlens,
                               const void* tlens, int S1, int B, int K, int x, int o1, int e1,
                               int o2, int e2, int run_cap, void* ops, void* lens, void* nruns,
                               void* overflow, void* stream) {
  if (B <= 0) return 0;
  if (S1 < 1 || K < 1 || run_cap < 1) return (int)cudaErrorInvalidValue;
  const WfPen pen{x, o1 + e1, e1, o2 + e2, e2};
  wf_batch_traceback_kernel<<<(B + kTbThreads - 1) / kTbThreads, kTbThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(m), static_cast<const int*>(i1), static_cast<const int*>(d1),
      static_cast<const int*>(i2), static_cast<const int*>(d2), static_cast<const int*>(scores),
      static_cast<const int*>(qlens), static_cast<const int*>(tlens), S1, B, K, pen, run_cap,
      static_cast<uint8_t*>(ops), static_cast<int*>(lens), static_cast<int*>(nruns),
      static_cast<uint8_t*>(overflow));
  return (int)cudaGetLastError();
}

}  // extern "C"
