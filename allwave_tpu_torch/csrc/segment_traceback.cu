// Resumable traceback over one replayed segment of the segmented
// (checkpoint-replay) engine.
//
// Replaces: the XLA walk allwave_tpu/wfa/segmented.py `_traceback_core`
// (reached through `traceback_segment` and `_replay_tb_block`), a
// lax.while_loop of 32-hop lax.scan chunks with one batched scatter of
// the completed runs per chunk. Its plain twin is
// allwave_tpu_torch/wfa/segmented.py `traceback_segment_ref`.
//
// What bounds it on an H100: latency. Each hop is one dependent 2-byte
// load from a segment plane of hundreds of megabytes, and a walker takes
// one hop per mutation event plus one per <=255 matched bases, a few
// dozen a segment at 2% divergence. The bytes moved are tiny.
//
// Design: one thread per pair resumes from the walk state (d, c, comp,
// active, open run op, open run length), reads the plane at row
// d - d_lo - 1 and column c - c_lo, and writes the walk state back; the
// open run stays in the walk state across segments. Completed runs go
// straight to the (B, run_cap) buffers. The rules are the XLA walk's, so
// the buffers and the walk state equal it byte for byte: walkers pause
// at d <= d_lo and finish at d <= 0; a match run is skipped in bulk
// through the plane's run-length byte; runs merge while the op is the
// same and the length stays <= 255; runs past run_cap are dropped and
// still counted in nrun; hops come in chunks of 32, at most
// (2 * n_steps + 8) / 32 + 2 chunks a segment, and a walker whose buffer
// overflowed stops at the end of that chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;

__global__ void segment_traceback_kernel(
    const uint16_t* __restrict__ planes, int NS, int B, int W, int d_lo,
    const int* __restrict__ c_lo, int* __restrict__ walk,
    uint8_t* __restrict__ ops, uint8_t* __restrict__ lens,
    int* __restrict__ nrun_p, uint8_t* __restrict__ overflow_p,
    int run_cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int d = walk[0 * B + b];
  int c = walk[1 * B + b];
  int comp = walk[2 * B + b];  // 0=S, 1=I1, 2=D1, 3=I2, 4=D2
  bool active = walk[3 * B + b] != 0;
  int cur_op = walk[4 * B + b];
  int cur_len = walk[5 * B + b];
  int nrun = nrun_p[b];
  bool overflow = overflow_p[b] != 0;
  const int col0 = c_lo == nullptr ? 0 : c_lo[b];
  uint8_t* ops_row = ops + (size_t)b * run_cap;
  uint8_t* lens_row = lens + (size_t)b * run_cap;
  const size_t plane_stride = (size_t)B * W;
  const uint16_t* prow = planes + (size_t)b * W;
  const int max_chunks = (2 * NS + 8) / kChunk + 2;

  for (int chunk = 0; chunk < max_chunks && active && d > d_lo; ++chunk) {
    bool oob = false;
    for (int hop = 0; hop < kChunk && active && d > d_lo; ++hop) {
      const int r = d - d_lo - 1;
      const int cc = c - col0;
      int v = 0;
      if (r >= 0 && r < NS && cc >= 0 && cc < W)
        v = prow[(size_t)r * plane_stride + cc];
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
        if (cur_len > 0 && !same) {  // store the completed run
          if (nrun < run_cap) {
            ops_row[nrun] = (uint8_t)cur_op;
            lens_row[nrun] = (uint8_t)cur_len;
          } else {
            oob = true;
          }
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
      if (new_d <= 0) active = false;
      d = new_d;
      c = new_c;
      comp = new_comp;
    }
    if (oob) {
      overflow = true;
      active = false;
    }
  }

  walk[0 * B + b] = d;
  walk[1 * B + b] = c;
  walk[2 * B + b] = comp;
  walk[3 * B + b] = active ? 1 : 0;
  walk[4 * B + b] = cur_op;
  walk[5 * B + b] = cur_len;
  nrun_p[b] = nrun;
  overflow_p[b] = overflow ? 1 : 0;
}

}  // namespace

extern "C" {

// planes (NS, B, W) uint16; walk (6, B) int32 rows d, c, comp, active,
// cur_op, cur_len; ops/lens (B, run_cap) uint8; nrun (B,) int32;
// overflow (B,) bool. c_lo may be null. Updates walk and the buffers in
// place.
int allwave_segment_traceback(const void* planes, int NS, int B, int W,
                              int d_lo, const void* c_lo, void* walk,
                              void* ops, void* lens, void* nrun,
                              void* overflow, int run_cap, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  segment_traceback_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(planes), NS, B, W, d_lo,
      static_cast<const int*>(c_lo), static_cast<int*>(walk),
      static_cast<uint8_t*>(ops), static_cast<uint8_t*>(lens),
      static_cast<int*>(nrun), static_cast<uint8_t*>(overflow), run_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
