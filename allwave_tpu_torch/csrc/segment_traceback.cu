// Resumable traceback over one replayed segment of the segmented
// (checkpoint-replay) engine.
//
// Replaces: the XLA walk allwave_tpu/wfa/segmented.py `_traceback_core`
// (reached through `traceback_segment` and `_replay_tb_block`), a
// lax.while_loop of 32-hop lax.scan chunks with one batched scatter of
// the completed runs per chunk. Its plain twin is
// allwave_tpu_torch/wfa/segmented.py `traceback_segment_ref`; the plain
// emulation of this kernel's tile schedule is `traceback_segment_tiles`
// there.
//
// What bounds it on an H100: the dependent chain of hops. A walker takes
// one hop per mutation event plus one per <=255 matched bases, a few
// dozen a segment at 2% divergence, and each hop's plane entry decides
// where the next one is. Read from the (n_steps, B, W) uint16 plane in
// device memory (18 MB a pair at n_steps 2048, W 4480: far larger than
// L2), every hop waits on a DRAM round trip. Read from shared memory, a
// hop is one thread's chain of ~70 instructions (the load, the run
// merge and store, the move), ~0.2 µs at ~5 cycles an instruction; the
// bytes are tiny.
//
// Design: one block a pair. Lane 0 of warp 0 walks; warps 1..N are
// producers, one for each of N slots of a ring of tiles in shared
// memory. A tile is R plane rows on a fixed row grid (tile t holds rows
// t*R .. t*R + R - 1; R about a quarter of the segment, at most 128) by
// 64 entries a row: the 16-byte-aligned run of the plane row that covers
// columns lo .. lo + 55 (Wc = 56), lo centred on the walker's column
// when the walker asked for the tile. Tile t
// lives in slot t & (N - 1). The walker only moves to lower rows, so
// when it enters tile t it asks (a 64-bit mailbox a slot: tile and lo)
// for every tile of t - N + 1 .. t not asked for yet: the tiles below
// it load while it walks (a match run that jumps over a tile leaves it
// unasked for). A producer warp copies its slot's tile with cp.async
// (16 bytes a lane, zero-filled past the plane's end), waits for its
// copies and publishes the tile number with a release store; the walker
// reads an entry from a tile once it has seen that number with an
// acquire load. cp.async rather than TMA: plane rows are B * W * 2 bytes
// apart, which need not be a multiple of 16 (odd windows), and a row's
// 16-byte run starts (row * B * W + b * W + lo) & 7 entries before lo,
// which the walker adds back to its index. A hop whose entry lies
// outside its tile's columns (a gap run that drifts more than ~28
// columns from where the tile was centred) reads that entry from device
// memory and counts a miss; the result is the same either way. The walk
// state stays in registers, completed runs go straight to the
// (B, run_cap) buffers. Slots and tile rows come from shifts and masks:
// no division in any loop. The hop's common case is short: once the
// walker has seen its tile ready, a hop whose row and column fall in it
// tests both with two unsigned compares against offsets kept for the
// tile and loads the entry by its shared address (ld.shared, no generic
// address to convert); a new tile, its first read and a miss take the
// long way.
//
// The rules are the XLA walk's, so the buffers and the walk state equal
// it byte for byte: walkers pause at d <= d_lo and finish at d <= 0; a
// match run is skipped in bulk through the plane's run-length byte; runs
// merge while the op is the same and the length stays <= 255; runs past
// run_cap are dropped and still counted in nrun; hops come in chunks of
// 32, at most (2 * n_steps + 8) / 32 + 2 chunks a segment, and a walker
// whose buffer overflowed stops at the end of that chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_tiles.cuh"

namespace {

using namespace walk_tiles;

constexpr int kChunk = 32;
constexpr int kRowLog = 6;                // a tile row: 64 entries, 8 x 16 bytes
constexpr int kWc = (1 << kRowLog) - 8;   // columns every row of a tile covers

struct Design {
  int log_r, log_n;  // R = 1 << log_r rows a tile, N = 1 << log_n slots
};

int smem_of(const Design& g) { return (1 << (g.log_n + g.log_r + kRowLog)) * 2; }

// 16 bytes from global to shared memory; only the first `bytes` are
// read, the rest of the 16 are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__global__ void segment_traceback_kernel(
    const uint16_t* __restrict__ planes, int NS, int B, int W, int d_lo,
    const int* __restrict__ c_lo, int* __restrict__ walk,
    uint8_t* __restrict__ ops, uint8_t* __restrict__ lens,
    int* __restrict__ nrun_p, uint8_t* __restrict__ overflow_p,
    int run_cap, int* __restrict__ stats, Design g) {
  extern __shared__ __align__(16) uint16_t tiles[];  // [N][R][64]
  __shared__ unsigned long long req[kMaxSlots];     // mailbox: tile << 32 | lo
  __shared__ int ready[kMaxSlots];                  // the tile a slot holds
  __shared__ int slot_lo[kMaxSlots];                // the walker's copy of lo

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slots = 1 << g.log_n;
  if (threadIdx.x < n_slots) {
    req[threadIdx.x] = kNone;
    ready[threadIdx.x] = -1;
  }
  __syncthreads();
  int d = walk[0 * B + b];
  bool active = walk[3 * B + b] != 0;
  if (!(active && d > d_lo)) {  // nothing moves: the state stays as it is
    if (threadIdx.x == 0 && stats != nullptr) {
      stats[b] = 0;
      stats[B + b] = 0;
    }
    return;
  }
  const size_t BW = (size_t)B * W;
  const int tile_log = g.log_r + kRowLog;  // entries a tile, log2

  if (warp > 0) {
    // producer of slot warp - 1: serve each new request of its mailbox
    const int p = warp - 1;
    if (p >= n_slots) return;
    uint16_t* tile = tiles + ((size_t)p << tile_log);
    const size_t total = (size_t)NS * BW;
    unsigned long long last = kNone;
    for (;;) {
      unsigned long long q = 0;
      if (lane == 0) {
        for (q = ld_acquire64(&req[p]); q == last; q = ld_acquire64(&req[p])) __nanosleep(64);
      }
      q = __shfl_sync(FULL, q, 0);
      if (q == kDone) break;
      last = q;
      const int t = (int)(q >> 32), lo = (int)(unsigned)q;
      const int row0 = t << g.log_r;
      const int nrows = min(1 << g.log_r, NS - row0);
      // 4 rows an iteration, 8 lanes of 16 bytes a row: this lane's rows
      // are rr0, rr0 + 4, ..., its bytes j8 .. j8 + 7 of each row's run
      const int rr0 = lane >> 3, j8 = 8 * (lane & 7);
      const int n_it = nrows > rr0 ? (nrows - rr0 + 3) >> 2 : 0;
      size_t e = (size_t)(row0 + rr0) * BW + (size_t)b * W + lo;
      uint16_t* dst = tile + (rr0 << kRowLog) + j8;
#pragma unroll 4
      for (int it = 0; it < n_it; ++it, e += 4 * BW, dst += 4 << kRowLog) {
        const size_t at = (e & ~(size_t)7) + j8;
        if (at < total) cp_async16(dst, planes + at, total - at >= 8 ? 16 : (int)(2 * (total - at)));
      }
      cp_async_wait_all();
      __threadfence_block();
      __syncwarp();
      if (lane == 0) st_release(&ready[p], t);
    }
    return;
  }
  if (lane != 0) return;

  // the walker
  int c = walk[1 * B + b];
  int comp = walk[2 * B + b];  // 0=S, 1=I1, 2=D1, 3=I2, 4=D2
  int cur_op = walk[4 * B + b];
  int cur_len = walk[5 * B + b];
  int nrun = nrun_p[b];
  bool overflow = overflow_p[b] != 0;
  const int col0 = c_lo == nullptr ? 0 : c_lo[b];
  uint8_t* ops_row = ops + (size_t)b * run_cap;
  uint8_t* lens_row = lens + (size_t)b * run_cap;
  const uint16_t* prow = planes + (size_t)b * W;
  // hops in chunks of kChunk, as the XLA walk's scan: a walker whose
  // buffer overflowed stops at the end of that chunk
  const int max_hops = ((2 * NS + 8) / kChunk + 2) * kChunk;
  const int mask = n_slots - 1;
  const int R = 1 << g.log_r;
  const int wc = min(kWc, W);  // the columns a tile covers, all inside the window
  // an entry's place in its row's 16-byte run: (e0 + r * B * W + lo) & 7
  const unsigned e0 = (unsigned)b * (unsigned)W;
  const unsigned bw32 = (unsigned)BW;
  const unsigned tiles_s = smem_addr(tiles);
  int req_lo = 0x7fffffff;  // the lowest tile asked for
  int have_t = -1, have_lo = 0;  // the walker's tile, its lo
  bool have_ready = false;
  // the walker's tile once seen ready: its first row (far below any row
  // until then), lo, the shared address of its first entry, and the
  // run offset of its first row
  int f_r0 = -0x40000000, f_lo = 0;
  unsigned f_base = 0, f_sh0 = 0;
  int f_d0 = f_r0, f_c0 = 0;  // the same as d and c: d_lo + 1 + f_r0, col0 + f_lo
  int hops = 0, misses = 0;
  bool oob = false;
  uint8_t* op_at = ops_row + nrun;  // where the next completed run goes
  uint8_t* len_at = lens_row + nrun;

  for (int i = 0; i < max_hops && d > d_lo; ++i) {
    ++hops;
    const int r = d - d_lo - 1;  // >= 0
    const int cc = c - col0;
    int v = 0;
    int rel = d - f_d0;
    int x = c - f_c0;
    if ((unsigned)rel >= (unsigned)R || (unsigned)x >= (unsigned)wc) {
      // not in the walker's tile as seen ready: a new tile, its first
      // read, or a miss
      rel = -1;
      if (r < NS && (unsigned)cc < (unsigned)W) {
        const int t = r >> g.log_r;
        if (t != have_t) {
          // entering tile t: ask for t - N + 1 .. t, those not asked
          // yet, centred on this column
          const int new_lo = max(t - mask, 0);
          if (new_lo < req_lo) {
            const int lo = min(max(cc - kWc / 2, 0), max(W - kWc, 0));
            for (int u = min(req_lo - 1, t); u >= new_lo; --u) {
              slot_lo[u & mask] = lo;
              st_relaxed64(&req[u & mask], ((unsigned long long)(unsigned)u << 32) | (unsigned)lo);
            }
            req_lo = new_lo;
          }
          have_t = t;
          have_lo = slot_lo[t & mask];
          have_ready = false;
        }
        if ((unsigned)(cc - have_lo) < (unsigned)wc) {
          if (!have_ready) {
            while (ld_acquire(&ready[t & mask]) != t) {
            }
            have_ready = true;
          }
          f_r0 = t << g.log_r;
          f_lo = have_lo;
          f_base = tiles_s + (((t & mask) << tile_log) << 1);
          f_sh0 = e0 + (unsigned)f_r0 * bw32 + (unsigned)have_lo;
          f_d0 = d_lo + 1 + f_r0;
          f_c0 = col0 + f_lo;
          rel = r - f_r0;
          x = cc - f_lo;
        } else {
          v = prow[(size_t)r * BW + cc];
          ++misses;
        }
      }
    }
    if (rel >= 0) {
      const unsigned shift = (f_sh0 + (unsigned)rel * bw32) & 7u;
      v = ld_shared_u16(f_base + ((((unsigned)rel << kRowLog) + (unsigned)x + shift) << 1));
    }
    const int src = v & 7;
    const int run_i = max(v >> 8, 1);

    const bool is_s = comp == 0;
    const bool is_i = comp & 1;  // I1 or I2
    const bool is_match_run = is_s && src == 0;
    const bool emits = !is_s || src < 2;  // a gap hop, a match run or a mismatch
    const int emit_op = is_match_run ? 'M' : (is_s ? 'X' : (is_i ? 'I' : 'D'));
    const int emit_len = is_match_run ? run_i : 1;
    // merge into the open run while the op is the same and the length
    // stays <= 255, else store the completed run
    const bool same = cur_len > 0 && cur_op == emit_op && cur_len + emit_len <= 255;
    if (emits && cur_len > 0 && !same) {
      if (nrun < run_cap) {
        *op_at = (uint8_t)cur_op;
        *len_at = (uint8_t)cur_len;
      } else {
        oob = true;
      }
      ++nrun;
      ++op_at;
      ++len_at;
    }
    cur_len = emits ? (same ? cur_len + emit_len : emit_len) : cur_len;
    cur_op = emits ? emit_op : cur_op;
    // a match run or a mismatch moves 2 * length anti-diagonals, a gap
    // hop one and a column; an open moves to the gap component src 2 ->
    // I1, 3 -> I2, 4 -> D1, 5.. -> D2; a gap hop closes unless the plane
    // entry's extend bit for its component (bits 3..6) is set
    d -= is_s ? (emits ? 2 * emit_len : 0) : 1;
    c += is_s ? 0 : (is_i ? -1 : 1);
    comp = is_s ? (emits ? 0 : (int)((0x44423100u >> (4 * src)) & 15u))
                : (((v >> (comp + 2)) & 1) ? comp : 0);
    if (oob && (i & (kChunk - 1)) == kChunk - 1) break;
  }
  if (d <= 0) active = false;
  if (oob) {
    overflow = true;
    active = false;
  }
  for (int p = 0; p < n_slots; ++p) st_relaxed64(&req[p], kDone);

  walk[0 * B + b] = d;
  walk[1 * B + b] = c;
  walk[2 * B + b] = comp;
  walk[3 * B + b] = active ? 1 : 0;
  walk[4 * B + b] = cur_op;
  walk[5 * B + b] = cur_len;
  nrun_p[b] = nrun;
  overflow_p[b] = overflow ? 1 : 0;
  if (stats != nullptr) {
    stats[b] = hops;
    stats[B + b] = misses;
  }
}

// The design for a walk over an (NS, B, W) plane: R rows a tile, about
// a quarter of the segment and at most 128 (a segment of 2048 rows is 16
// tiles; a tile lands in ~1 µs, while the walker takes ~7 hops to cross
// it), N = 4 slots (three tiles below the walker's load while it walks),
// 64 KB of shared memory at R = 128.
Design choose(int NS, int W) {
  (void)W;
  return Design{tile_rows_log(NS, 7), 2};
}

}  // namespace

extern "C" {

// The walk's design for an (NS, B, W) plane, as a code: bits 0-3 log2
// of the rows a tile (R), bits 4-7 log2 of the slots (N), bits 8-15 the
// columns a tile row covers (Wc), bits 16-19 the block's warps (N + 1).
int allwave_segment_traceback_design(int NS, int W) {
  const Design g = choose(NS, W);
  return g.log_r | (g.log_n << 4) | (kWc << 8) | (((1 << g.log_n) + 1) << 16);
}

// planes (NS, B, W) uint16, 16-byte aligned; walk (6, B) int32 rows d,
// c, comp, active, cur_op, cur_len; ops/lens (B, run_cap) uint8; nrun
// (B,) int32; overflow (B,) bool; stats (2, B) int32 or null: each
// walker's hops and misses of this call. c_lo may be null. design: a
// code of allwave_segment_traceback_design. Updates walk and the
// buffers in place.
int allwave_segment_traceback(const void* planes, int NS, int B, int W,
                              int d_lo, const void* c_lo, void* walk,
                              void* ops, void* lens, void* nrun,
                              void* overflow, int run_cap, void* stats,
                              int design, void* stream) {
  if (B <= 0) return 0;
  const Design g{design & 15, (design >> 4) & 15};
  if ((reinterpret_cast<uintptr_t>(planes) & 15) != 0 || g.log_n > 3 || g.log_r > 12)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_of(g);
  static int allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem((const void*)segment_traceback_kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  segment_traceback_kernel<<<B, 32 * ((1 << g.log_n) + 1), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(planes), NS, B, W, d_lo,
      static_cast<const int*>(c_lo), static_cast<int*>(walk),
      static_cast<uint8_t*>(ops), static_cast<uint8_t*>(lens),
      static_cast<int*>(nrun), static_cast<uint8_t*>(overflow), run_cap,
      static_cast<int*>(stats), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
