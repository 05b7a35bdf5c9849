// Resumable traceback over one replayed segment of the wavefront
// checkpoint-replay engine.
//
// Replaces: the XLA walk allwave_tpu/wfa/wf_segmented.py
// `_traceback_window` (reached through `wf_replay_tb_block` and
// `wf_replay_tb_narrow`), a lax.while_loop of 16-hop lax.scan chunks
// with nine window reads a hop and one batched scatter of the emits per
// chunk. Its plain twin is allwave_tpu_torch/wfa/wf_segmented.py
// `traceback_window_ref`.
//
// What bounds it on an H100: latency. A walker takes one hop per
// mutation or gap event (a few dozen per 256-level segment at 0.25%
// divergence), each a handful of dependent 4-byte loads from the
// segment's history planes; the bytes moved are tiny.
//
// Design: one thread per pair resumes from the walk state (s, c, h,
// comp, active) and reads its window directly: the head rows (scores
// s_lo - D + 1 .. s_lo) from the checkpoint ring image, where a slot
// older than its component's depth or a score below 0 reads NULL (as
// pallas_wf.ckpt_to_buf leaves it), and the body rows from the (n_steps,
// 5, B, W) history planes. On a narrow replay the window column is
// c - c_lo. The XLA loop runs while any pair steps, but a pair that does
// not step changes nothing, so every pair runs on its own up to the same
// per-call bound. Kept byte for byte: the tie order X > I1 > I2 > D1 >
// D2; gap extend before open; the origin emit at s == 0; two emit slots
// per hop (the M-run/I/D emit, then the X emit); emits past run_cap
// dropped while nrun counts on; an overflowing walker goes inactive at
// the end of its 16-hop chunk; walkers pause at s <= s_lo unless s == 0;
// at most (3 * run_cap + 8) / 16 + 2 chunks a segment.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_NULL (-(1 << 30))

namespace {

constexpr int kChunk = 16;

struct TbPen {
  int x, e1, e2, o1e1, o2e2;
  int off[5], dep[5];
  int D;  // window head rows: max_lookback + 1
};

__global__ void wf_traceback_kernel(
    const int* __restrict__ hist, int NS, int B, int W,
    const int* __restrict__ ring, int K, const int* __restrict__ c_lo,
    int s_lo, TbPen pen, int* __restrict__ walk, uint8_t* __restrict__ ops,
    int* __restrict__ lens, int* __restrict__ nrun_p,
    uint8_t* __restrict__ overflow_p, int run_cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int s = walk[0 * B + b];
  int c = walk[1 * B + b];
  int h = walk[2 * B + b];
  int comp = walk[3 * B + b];  // 0=m 1=i1 2=d1 3=i2 4=d2
  bool active = walk[4 * B + b] != 0;
  int nrun = nrun_p[b];
  bool overflow = overflow_p[b] != 0;
  const int col0 = c_lo == nullptr ? 0 : c_lo[b];
  uint8_t* ops_row = ops + (size_t)b * run_cap;
  int* lens_row = lens + (size_t)b * run_cap;
  const int s_base = s_lo - pen.D + 1;  // score of window row 0
  const int n_rows = pen.D + NS;
  const size_t cs = (size_t)B * W;

  // window value of component cp at score fs, window column fc
  auto win = [&](int cp, int fs, int fc) -> int {
    const int r = fs - s_base;
    if (r < 0 || r >= n_rows || fs < 0 || fc < 0 || fc >= W) return AW_NULL;
    if (r >= pen.D)
      return hist[((size_t)(r - pen.D) * 5 + cp) * cs + (size_t)b * W + fc];
    const int dep = pen.dep[cp];
    if (s_lo - fs >= dep) return AW_NULL;
    return ring[((size_t)(pen.off[cp] + fs % dep) * B + b) * K + col0 + fc];
  };

  bool oob = false;
  auto emit = [&](int op, int cnt) {
    if (nrun < run_cap) {
      ops_row[nrun] = (uint8_t)op;
      lens_row[nrun] = cnt;
    } else {
      oob = true;
    }
    ++nrun;
  };

  const int max_chunks = (3 * run_cap + 8) / kChunk + 2;
  for (int chunk = 0; chunk < max_chunks; ++chunk) {
    if (!(active && (s > s_lo || s == 0))) break;
    oob = false;
    // a walker that stops stepping changes nothing for the rest of the
    // chunk
    for (int hop = 0; hop < kChunk && active && (s > s_lo || s == 0); ++hop) {
      const int cc = c - col0;
      if (comp == 0) {
        const int mis_v = win(0, s - pen.x, cc);
        const int cx = mis_v > AW_NULL ? mis_v + 1 : AW_NULL;
        const int ci1 = win(1, s, cc);
        const int cd1 = win(2, s, cc);
        const int ci2 = win(3, s, cc);
        const int cd2 = win(4, s, cc);
        const int pre = max(max(max(cx, ci1), max(cd1, ci2)), cd2);
        const int choice = cx == pre    ? 0
                           : ci1 == pre ? 1
                           : ci2 == pre ? 3
                           : cd1 == pre ? 2
                                        : 4;
        const bool at_origin = s == 0;
        const int n_match = at_origin ? h : h - pre;
        if (n_match > 0) emit('M', n_match);
        if (at_origin) {
          active = false;
        } else {
          if (choice == 0) {
            emit('X', 1);
            s -= pen.x;
            h = pre - 1;
          } else {
            h = pre;
          }
          comp = choice;
        }
      } else {
        const bool is_i = comp == 1 || comp == 3;
        const bool piece1 = comp == 1 || comp == 2;
        const int e = piece1 ? pen.e1 : pen.e2;
        const int oe = piece1 ? pen.o1e1 : pen.o2e2;
        const int ev = win(comp, s - e, is_i ? cc - 1 : cc + 1);
        const bool ext_ok = ev > AW_NULL && (is_i ? ev + 1 == h : ev == h);
        emit(is_i ? 'I' : 'D', 1);
        s -= ext_ok ? e : oe;
        if (!ext_ok) comp = 0;
        c = is_i ? c - 1 : c + 1;
        if (is_i) h -= 1;
      }
    }
    if (oob) {
      overflow = true;
      active = false;
    }
  }

  walk[0 * B + b] = s;
  walk[1 * B + b] = c;
  walk[2 * B + b] = h;
  walk[3 * B + b] = comp;
  walk[4 * B + b] = active ? 1 : 0;
  nrun_p[b] = nrun;
  overflow_p[b] = overflow ? 1 : 0;
}

}  // namespace

extern "C" {

// hist (NS, 5, B, W) int32; ring (P, B, K) int32, the checkpoint image at
// s_lo; c_lo (B,) int32 or null; walk (5, B) int32 rows s, c, h, comp,
// active; ops (B, run_cap) uint8; lens (B, run_cap) int32; nrun (B,)
// int32; overflow (B,) bool. Updates walk and the buffers in place.
int allwave_wf_traceback(const void* hist, int NS, int B, int W,
                         const void* ring, int K, const void* c_lo, int s_lo,
                         int x, int o1, int e1, int o2, int e2, int off0,
                         int off1, int off2, int off3, int off4, int dep0,
                         int dep1, int dep2, int dep3, int dep4, int D,
                         void* walk, void* ops, void* lens, void* nrun,
                         void* overflow, int run_cap, void* stream) {
  if (B <= 0) return 0;
  TbPen pen;
  pen.x = x;
  pen.e1 = e1;
  pen.e2 = e2;
  pen.o1e1 = o1 + e1;
  pen.o2e2 = o2 + e2;
  const int offs[5] = {off0, off1, off2, off3, off4};
  const int deps[5] = {dep0, dep1, dep2, dep3, dep4};
  for (int i = 0; i < 5; ++i) {
    pen.off[i] = offs[i];
    pen.dep[i] = deps[i];
  }
  pen.D = D;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  wf_traceback_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), NS, B, W, static_cast<const int*>(ring),
      K, static_cast<const int*>(c_lo), s_lo, pen, static_cast<int*>(walk),
      static_cast<uint8_t*>(ops), static_cast<int*>(lens),
      static_cast<int*>(nrun), static_cast<uint8_t*>(overflow), run_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
