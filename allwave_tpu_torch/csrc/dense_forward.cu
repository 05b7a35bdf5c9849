// Banded Gotoh forward sweep over anti-diagonals, with the merged
// choice/run-length traceback plane.
//
// Replaces: allwave_tpu/wfa/pallas_dense.py `_forward_t` (kernel
// `_kernel_t` / `run_dp_chunk_t`, K <= 2048) and `_forward_c2` (kernel
// `_kernel_c2` / `run_dp_chunk_c2`, the escalation bands 2048 < K <=
// 16384). Both compute the function of allwave_tpu/wfa/dense.py
// `dense_forward`; they differ only in TPU layout, so one kernel serves
// every K here. Its plain twin is allwave_tpu_torch/wfa/dense.py
// `dense_forward_ref`.
//
// What bounds it on an H100: the sweep is a chain of 2*l_pad dependent
// steps per pair, each a handful of integer min/add ops per band lane
// and one 2-byte plane store per lane. At K = 128 a batch of 4096 pairs
// of 1 kb stores 2.1 GB of plane, about 0.7 ms of HBM bandwidth, while
// the ~60 integer ops per cell and one block barrier per step cost more:
// the kernel is bound by issue and barrier latency, not by memory.
//
// Design: one block per pair, the step loop inside the block (the
// TPU's sequential grid axis becomes this loop). Lanes are the band's
// diagonals, strided over up to 1024 threads. The five int32 bands and
// the run-length band are double-buffered so that each step needs one
// barrier: step d reads buffer (d-1)&1 and writes buffer d&1. They live
// in shared memory (42 bytes a lane) while that fits; wider bands
// (K > SMEM_MAX_K in wfa/dense.py) keep them in a per-pair global
// scratch that the wrapper allocates and L2 holds. The substitution
// bases are read directly as q[v-1] and t[h-1], with the same clamped
// indices the XLA shift registers produce, so every plane byte --
// reachable or not -- equals the reference's. Plane offsets are 64-bit: D2*B*K passes 2^31
// on wide batches.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace {

struct Pen {
  int x, o1e1, e1, o2e2, e2, o1, o2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

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

}  // namespace

extern "C" {

int allwave_dense_forward(const void* qs, const void* ts, const void* qlens,
                          const void* tlens, int B, int l_pad, int K, int x,
                          int o1, int e1, int o2, int e2, int two_piece,
                          void* scores, void* cert, void* planes,
                          void* iscratch, void* rscratch, void* stream) {
  Pen pen;
  pen.x = x;
  pen.o1 = o1;
  pen.e1 = e1;
  pen.o2 = o2;
  pen.e2 = e2;
  pen.o1e1 = o1 + e1;
  pen.o2e2 = two_piece ? o2 + e2 : 0;
  const int threads = K >= 1024 ? 1024 : ((K + 31) / 32) * 32;
  const int smem = iscratch == nullptr ? 42 * K : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
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
