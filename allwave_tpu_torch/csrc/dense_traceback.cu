// Traceback over the dense forward's choice/run-length plane, fused
// with the packed-result epilogue.
//
// Replaces: the XLA walk allwave_tpu/wfa/dense.py `dense_traceback`
// (a lax.while_loop of 32-hop lax.scan chunks) and the
// `dense_align_packed` epilogue that reduces the PAF stats and packs
// the result. The JAX package never wrote this step in Pallas; here it
// is a kernel because a plain-torch walk costs tens of launches per hop
// and thousands per batch. Its plain twin is
// allwave_tpu_torch/wfa/dense.py `dense_traceback_ref` +
// `pack_alignments`.
//
// What bounds it on an H100: latency. Each hop is one dependent 2-byte
// load from a plane of gigabytes (no reuse, no coalescing across
// pairs), and a pair takes one hop per mutation event plus one per
// <=255 matched bases. The bytes moved are tiny.
//
// Design: one thread per pair walks from (qlen+tlen, c_end) to the
// origin, skipping match runs in bulk with the plane's run-length byte.
// The run being built stays in registers; a completed run is stored
// straight into the packed output row (2-bit op code, length byte) and
// its length added to the M/X/I/D sums, so the epilogue needs no second
// pass. Many pairs per block keep enough loads in flight to hide the
// latency. The run-merge rule, the hop bound, the drops past run_cap
// (still counted in nrun), the final flush and the overflow rule are
// those of the XLA walk, so the packed bytes are identical.
//
// Output row layout, (32 + ceil(cap/4) + cap) bytes:
//   8 little-endian int32: score, nruns, cert, overflow, M, M+X, M+X+D,
//   M+X+I | ops, 2 bits each (M=0, X=1, I=2, D=3; an empty slot packs
//   as 3) | run lengths.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace {

__device__ __forceinline__ void put_i32(uint8_t* p, int v) {
  const unsigned u = (unsigned)v;
  p[0] = (uint8_t)(u & 0xFF);
  p[1] = (uint8_t)((u >> 8) & 0xFF);
  p[2] = (uint8_t)((u >> 16) & 0xFF);
  p[3] = (uint8_t)((u >> 24) & 0xFF);
}

// op byte ('M','X','I','D') -> 2-bit code
__device__ __forceinline__ int op_code(int op) {
  return op == 'M' ? 0 : (op == 'X' ? 1 : (op == 'I' ? 2 : 3));
}

__global__ void dense_traceback_kernel(
    const uint16_t* __restrict__ planes, const int* __restrict__ scores,
    const uint8_t* __restrict__ cert, const int* __restrict__ qlens,
    const int* __restrict__ tlens, int B, int D2, int K, int run_cap,
    uint8_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int cap4 = (run_cap + 3) / 4;
  const int row_bytes = 32 + cap4 + run_cap;
  uint8_t* row = out + (size_t)b * row_bytes;
  uint8_t* ops = row + 32;
  uint8_t* lens = row + 32 + cap4;
  for (int i = 0; i < cap4; ++i) ops[i] = 0xFF;
  for (int i = 0; i < run_cap; ++i) lens[i] = 0;

  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int score = scores[b];
  const int k_end = tlen - qlen;
  const int abs_kend = k_end < 0 ? -k_end : k_end;
  int k0 = min(0, k_end) - ((K - 1 - abs_kend) >> 1);
  k0 -= (k0 & 1);

  int d = qlen + tlen;
  int c = k_end - k0;
  c = c < 0 ? 0 : (c > K - 1 ? K - 1 : c);
  int comp = 0;  // 0=S, 1=I1, 2=D1, 3=I2, 4=D2
  bool active = score < AW_INF && d > 0;
  int cur_op = 0, cur_len = 0, nrun = 0;
  bool overflow = false;
  int cnt_m = 0, cnt_x = 0, cnt_i = 0, cnt_d = 0;

  const size_t plane_stride = (size_t)B * K;
  const uint16_t* prow = planes + (size_t)b * K;
  // the XLA walk runs whole 32-hop chunks, at most max_chunks of them
  const int max_hops = (((2 * D2 + 8 + 31) / 32) + 1) * 32;

  auto store = [&](int op, int len) {
    const int sh = 2 * (nrun & 3);
    ops[nrun >> 2] = (uint8_t)((ops[nrun >> 2] & ~(3 << sh)) | (op_code(op) << sh));
    lens[nrun] = (uint8_t)len;
    if (op == 'M') cnt_m += len;
    else if (op == 'X') cnt_x += len;
    else if (op == 'I') cnt_i += len;
    else cnt_d += len;
  };

  for (int hop = 0; hop < max_hops && active; ++hop) {
    int v = 0;
    if (d >= 1 && d <= D2 && c >= 0 && c < K)
      v = prow[(size_t)(d - 1) * plane_stride + c];
    const int byte = v & 0xFF;
    const int run = v >> 8;
    const int src = byte & 7;

    const bool is_s = comp == 0;
    const bool is_match_run = is_s && src == 0;
    const bool is_x = is_s && src == 1;
    const int run_i = run > 1 ? run : 1;
    const bool is_i = comp == 1 || comp == 3;
    const bool is_d = comp == 2 || comp == 4;

    if (is_match_run || is_x || is_i || is_d) {
      const int emit_op = is_match_run ? 'M' : (is_x ? 'X' : (is_i ? 'I' : 'D'));
      const int emit_len = is_match_run ? run_i : 1;
      const bool same =
          cur_len > 0 && cur_op == emit_op && cur_len + emit_len <= 255;
      if (cur_len > 0 && !same) {  // flush the completed run
        if (nrun < run_cap) store(cur_op, cur_len);
        else overflow = true;
        ++nrun;
      }
      cur_len = same ? cur_len + emit_len : emit_len;
      cur_op = emit_op;
    }

    int new_d, new_c, new_comp;
    if (is_s) {
      new_d = is_match_run ? d - 2 * run_i : (is_x ? d - 2 : d);
      new_c = c;
      new_comp = (is_match_run || is_x)
                     ? 0
                     : (src == 2 ? 1 : (src == 4 ? 2 : (src == 3 ? 3 : 4)));
    } else {
      const int ext_bit = (byte >> (comp + 2)) & 1;  // comp 1..4 -> bit 3..6
      new_d = d - 1;
      new_c = is_i ? c - 1 : c + 1;
      new_comp = ext_bit ? comp : 0;
    }
    if (new_d <= 0) {
      active = false;
    } else {
      d = new_d;
      c = new_c;
      comp = new_comp;
    }
  }

  // final flush of the still-open run
  const bool has_cur = cur_len > 0;
  const bool fits = has_cur && nrun < run_cap;
  if (fits) {
    store(cur_op, cur_len);
    ++nrun;
  }
  overflow = overflow || (has_cur && !fits) || nrun > run_cap || active;

  put_i32(row + 0, score);
  put_i32(row + 4, nrun);
  put_i32(row + 8, cert[b] ? 1 : 0);
  put_i32(row + 12, overflow ? 1 : 0);
  put_i32(row + 16, cnt_m);
  put_i32(row + 20, cnt_m + cnt_x);
  put_i32(row + 24, cnt_m + cnt_x + cnt_d);
  put_i32(row + 28, cnt_m + cnt_x + cnt_i);
}

}  // namespace

extern "C" {

int allwave_dense_traceback(const void* planes, const void* scores,
                            const void* cert, const void* qlens,
                            const void* tlens, int B, int D2, int K,
                            int run_cap, void* out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  dense_traceback_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(planes), static_cast<const int*>(scores),
      static_cast<const uint8_t*>(cert), static_cast<const int*>(qlens),
      static_cast<const int*>(tlens), B, D2, K, run_cap,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
