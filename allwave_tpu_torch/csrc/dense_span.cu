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
// lane and a block barrier. The long path's sweep runs few pairs (12 at
// 100 kb) on very wide bands (K up to 24576), so only B of the 132 SMs
// work, each bound by the issue rate of one block and by its L2 traffic
// when the bands do not fit in shared memory. The replay adds one
// 2-byte plane store per lane and step.
//
// Design: dense_forward.cu's tier 3, with the d-loop running d_lo+1 ..
// d_lo+n_steps. One block per pair; lanes strided over up to 1024
// threads; the five int32 bands and the run-length band double-buffered
// (one barrier per step) in shared memory up to SMEM_MAX_K lanes
// (wfa/segmented.py) and in a per-pair global scratch above. The state comes
// in from a checkpoint slice, optionally at a per-pair column offset
// c_lo into a wider band (the narrow replay: origin k0 + c_lo, INF
// inflow at the window's edges), and the state out goes straight to its
// slot (the next checkpoint, in the sweep). The run band starts at 0.
// PLANES is a template flag: the sweep writes no plane and keeps no run
// band. Bases are read as q[v-1] and t[h-1] at the clamped indices the
// XLA span's shift registers hold, so every state and plane byte --
// reachable or not -- equals the plain version's. Offsets into states
// and planes are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace {

struct Pen {
  int x, o1e1, e1, o2e2, e2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

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

template <bool TWO_PIECE, bool PLANES>
int launch(const void* qs, const void* ts, const void* qlens,
           const void* tlens, const void* c_lo, int B, int l_pad, int K,
           int W, int d_lo, int n_steps, Pen pen, const void* state_in,
           long long in_stride, void* state_out, long long out_stride,
           void* planes, void* iscratch, void* rscratch, cudaStream_t st) {
  const int threads = W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  const int smem = iscratch == nullptr ? 42 * W : 0;
  cudaFuncSetAttribute(dense_span_kernel<TWO_PIECE, PLANES>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dense_span_kernel<TWO_PIECE, PLANES><<<B, threads, smem, st>>>(
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

// state_in / state_out: five (B, K) / (B, W) int32 bands, band i at
// element offset i * (in|out)_band_stride; c_lo may be null (full band,
// W == K); planes (n_steps, B, W) uint16, written when with_planes.
// iscratch (B, 10, W) int32 and rscratch (B, 2, W) uint8 are null when
// the bands fit in shared memory.
int allwave_dense_span(const void* qs, const void* ts, const void* qlens,
                       const void* tlens, const void* c_lo, int B, int l_pad,
                       int K, int W, int d_lo, int n_steps, int x, int o1,
                       int e1, int o2, int e2, int two_piece,
                       int with_planes, const void* state_in,
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
  if (B <= 0) return 0;
#define AW_LAUNCH(TP, PL)                                                   \
  launch<TP, PL>(qs, ts, qlens, tlens, c_lo, B, l_pad, K, W, d_lo, n_steps, \
                 pen, state_in, in_band_stride, state_out, out_band_stride, \
                 planes, iscratch, rscratch, st)
  if (two_piece) return with_planes ? AW_LAUNCH(true, true) : AW_LAUNCH(true, false);
  return with_planes ? AW_LAUNCH(false, true) : AW_LAUNCH(false, false);
#undef AW_LAUNCH
}

}  // extern "C"
