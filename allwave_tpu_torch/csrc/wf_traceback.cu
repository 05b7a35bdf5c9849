// Resumable traceback over one replayed segment of the wavefront
// checkpoint-replay engine.
//
// Replaces: the XLA walk allwave_tpu/wfa/wf_segmented.py
// `_traceback_window` (reached through `wf_replay_tb_block` and
// `wf_replay_tb_narrow`), a lax.while_loop of 16-hop lax.scan chunks
// with nine window reads a hop and one batched scatter of the emits per
// chunk. Its plain twin is allwave_tpu_torch/wfa/wf_segmented.py
// `traceback_window_ref`; the plain emulation of this kernel's tile
// schedule is `traceback_window_tiles` there.
//
// What bounds it on an H100: the dependent chain of hops. A walker takes
// one hop per mutation or gap event (a few dozen per 256-level segment
// at 0.25% divergence); each hop reads up to five window entries whose
// values decide the next hop. Read from the (n_steps, 5, B, W) int32
// history planes in device memory (5.2 MB a pair at 256 levels and W
// 1024, 189 MB at B = 36: far larger than L2), every hop waits on a DRAM
// round trip. Read from shared memory, a hop is one thread's chain of
// instructions (~0.3 µs for a mismatch hop: five reads, the five-way
// max and tie order, two emits); the bytes are tiny.
//
// Design: one block a pair. Lane 0 of warp 0 walks; warps 1..N are
// producers, one for each of N slots of a ring of tiles in shared
// memory; warp N + 1 stages the window's head. A tile is R score levels
// of the history planes on a fixed grid (tile t holds levels t*R ..
// t*R + R - 1, scores s_lo + 1 + t*R ..) by the 5 components by Wc = 32
// window columns lo .. lo + 31, lo centred on the walker's column when
// the walker asked for the tile. Tile t lives in slot t & (N - 1). The
// walker's score only falls, so when it enters tile t it asks (a 64-bit
// mailbox a slot: tile and lo) for every tile of t - N + 1 .. t not
// asked for yet: the tiles below it load while it walks. A producer warp
// copies its slot's tile with 4-byte cp.async, a lane a column (a row of
// a component is 128 contiguous bytes; 4-byte copies need no alignment
// of the window's columns), waits for its copies and publishes the tile
// number with a release store; the walker reads a tile once it has seen
// that number with an acquire load. The head, the rows of scores
// s_lo - DH + 1 .. s_lo from the checkpoint ring image, is staged once
// at the start of the launch, in the same layout and centred on the
// walker's entry column, with every slot that is older than its
// component's depth, or below score 0, filled with NULL. Only DH =
// max(x, e1, e2) head rows can be read (a stepping walker has s > s_lo,
// or s == 0, and reads at s, s - x and s - e), though the window has
// D = max_lookback + 1; a read of a row outside the staged ones goes to
// device memory. Each component's ring slot for the head's top row is
// s_lo % depth, computed once a launch on the host; a row lower is one
// subtraction and wrap. A read whose entry lies outside its tile's
// columns, or in a tile the walker has not asked for, reads that entry
// from device memory and counts a miss; the result is the same either
// way. No division in any loop. The common case is short: the walker
// keeps its own tile and the one below it, once seen ready, as offsets
// and shared addresses; a read that falls in one of them is two
// unsigned compares and an ld.shared (a mismatch hop's four gap
// components at its own level share one test); the rest takes the long
// way.
//
// Kept byte for byte from the XLA walk: the tie order X > I1 > I2 > D1 >
// D2 (the instantiation FLIP = true, the reference's test-only mutation
// ALLWAVE_TB_FLIP, prefers I1 over X; the production one, FLIP = false,
// has no run-time test for it and compiles to the instructions the kernel
// had before it); gap extend before open; the origin emit at s == 0; two
// emit slots per hop (the M-run/I/D emit, then the X emit); emits past run_cap
// dropped while nrun counts on; an overflowing walker goes inactive at
// the end of its 16-hop chunk; walkers pause at s <= s_lo unless
// s == 0; at most (3 * run_cap + 8) / 16 + 2 chunks a segment.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_tiles.cuh"

#define AW_NULL (-(1 << 30))

namespace {

using namespace walk_tiles;

constexpr int kChunk = 16;
constexpr int kWc = 32;  // window columns a tile row covers: a lane each

struct TbPen {
  int x, e1, e2, o1e1, o2e2;
  int off[5], dep[5];
  int m0[5];  // s_lo % dep: each component's ring slot at score s_lo
  int D;      // window head rows: max_lookback + 1
  int DH;     // head rows a walker can read: max(x, e1, e2), at most D
};

struct Design {
  int log_r, log_n;  // R = 1 << log_r levels a tile, N = 1 << log_n slots
};

int smem_of(const Design& g, int DH) {
  return ((1 << (g.log_n + g.log_r)) + DH) * 5 * kWc * 4;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

template <bool FLIP>
__global__ void wf_traceback_kernel(
    const int* __restrict__ hist, int NS, int B, int W,
    const int* __restrict__ ring, int K, const int* __restrict__ c_lo,
    int s_lo, TbPen pen, int* __restrict__ walk, uint8_t* __restrict__ ops,
    int* __restrict__ lens, int* __restrict__ nrun_p,
    uint8_t* __restrict__ overflow_p, int run_cap, int* __restrict__ stats, Design g) {
  extern __shared__ __align__(16) int tiles[];  // [N][R][5][kWc], then head [DH][5][kWc]
  __shared__ unsigned long long req[kMaxSlots];  // mailbox: tile << 32 | lo
  __shared__ int ready[kMaxSlots];               // the tile a slot holds
  __shared__ int slot_lo[kMaxSlots];             // the walker's copy of lo
  __shared__ int head_ready;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slots = 1 << g.log_n;
  const int R = 1 << g.log_r;
  if (threadIdx.x < n_slots) {
    req[threadIdx.x] = kNone;
    ready[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) head_ready = 0;
  __syncthreads();
  int s = walk[0 * B + b];
  int c = walk[1 * B + b];
  bool active = walk[4 * B + b] != 0;
  if (!(active && (s > s_lo || s == 0))) {  // nothing moves
    if (threadIdx.x == 0 && stats != nullptr) {
      stats[b] = 0;
      stats[B + b] = 0;
    }
    return;
  }
  const int col0 = c_lo == nullptr ? 0 : c_lo[b];
  const size_t cs = (size_t)B * W;
  const int tile_n = R * 5 * kWc;  // entries a tile
  const int head_at = n_slots * tile_n;  // the head's first entry in `tiles`
  // the head's columns, centred on the entry column
  const int head_lo = min(max(c - col0 - kWc / 2, 0), max(W - kWc, 0));

  if (warp == n_slots + 1) {
    // stage the head: top row first, each component's slot one
    // subtraction and wrap below the last
    int slot[5];
#pragma unroll
    for (int cp = 0; cp < 5; ++cp) slot[cp] = pen.m0[cp];
    const int fc = head_lo + lane;
    for (int k = 0; k < pen.DH; ++k) {  // k = s_lo - score
      const int hr = pen.DH - 1 - k;
#pragma unroll
      for (int cp = 0; cp < 5; ++cp) {
        int* dst = tiles + head_at + (hr * 5 + cp) * kWc + lane;
        if (fc < W) {
          if (s_lo - k >= 0 && k < pen.dep[cp])
            cp_async4(dst, ring + ((size_t)(pen.off[cp] + slot[cp]) * B + b) * K + col0 + fc);
          else
            *dst = AW_NULL;
        }
        slot[cp] = slot[cp] == 0 ? pen.dep[cp] - 1 : slot[cp] - 1;
      }
    }
    cp_async_wait_all();
    __threadfence_block();
    __syncwarp();
    if (lane == 0) st_release(&head_ready, 1);
    return;
  }
  if (warp > 0) {
    // producer of slot warp - 1: serve each new request of its mailbox
    const int p = warp - 1;
    if (p >= n_slots) return;
    int* tile = tiles + (size_t)p * tile_n;
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
      const int lev0 = t << g.log_r;
      const int nlev = min(R, NS - lev0);
      const int fc = lo + lane;
      if (fc < W) {
        const int* src = hist + (size_t)lev0 * 5 * cs + (size_t)b * W + fc;
        int* dst = tile + lane;
#pragma unroll 2
        for (int i = 0; i < nlev; ++i, src += 5 * cs, dst += 5 * kWc) {
#pragma unroll
          for (int cp = 0; cp < 5; ++cp) cp_async4(dst + cp * kWc, src + cp * cs);
        }
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
  int h = walk[2 * B + b];
  int comp = walk[3 * B + b];  // 0=m 1=i1 2=d1 3=i2 4=d2
  int nrun = nrun_p[b];
  bool overflow = overflow_p[b] != 0;
  uint8_t* ops_row = ops + (size_t)b * run_cap;
  int* lens_row = lens + (size_t)b * run_cap;
  const int mask = n_slots - 1;
  int req_lo = 0x7fffffff;  // the lowest tile asked for
  int cur_t = -1;           // the tile of the walker's score
  // the walker's tile (a) and the one below it (b) once seen ready: the
  // level of its first row (far below any level until then), lo, and
  // the shared address of its first entry
  const int kNever = -0x40000000;
  int a_l0 = kNever, a_lo = 0, b_l0 = kNever, b_lo = 0;
  unsigned a_base = 0, b_base = 0;
  const unsigned tiles_s = smem_addr(tiles);
  const int wc = min(kWc, W);  // the columns a tile covers, all inside the window
  bool head_seen = false;
  int hops = 0, misses = 0;

  // an entry of the history planes: level i (score s_lo + 1 + i) of
  // component cp at window column fc
  auto body = [&](int cp, int i, int fc) -> int {
    const int t = i >> g.log_r;
    if (t >= req_lo) {
      const int lo = slot_lo[t & mask];
      const int x = fc - lo;
      if ((unsigned)x < (unsigned)kWc) {
        while (ld_acquire(&ready[t & mask]) != t) {
        }
        const unsigned base = tiles_s + (unsigned)((t & mask) * tile_n) * 4u;
        if (t == cur_t) {
          a_l0 = t << g.log_r;
          a_lo = lo;
          a_base = base;
        } else if (t == cur_t - 1) {
          b_l0 = t << g.log_r;
          b_lo = lo;
          b_base = base;
        }
        return tiles[(size_t)(t & mask) * tile_n + (((i & (R - 1)) * 5 + cp) * kWc) + x];
      }
    }
    ++misses;
    return hist[((size_t)i * 5 + cp) * cs + (size_t)b * W + fc];
  };
  // an entry of the head: k = s_lo - score, 0 <= k < D
  auto head_read = [&](int cp, int k, int fc) -> int {
    const int dep = pen.dep[cp];
    if (k >= dep) return AW_NULL;
    const int x = fc - head_lo;
    if (k < pen.DH && (unsigned)x < (unsigned)kWc) {
      if (!head_seen) {
        while (ld_acquire(&head_ready) != 1) {
        }
        head_seen = true;
      }
      return tiles[head_at + ((pen.DH - 1 - k) * 5 + cp) * kWc + x];
    }
    ++misses;
    int m = pen.m0[cp] - k;
    if (m < 0) m += dep;
    return ring[((size_t)(pen.off[cp] + m) * B + b) * K + col0 + fc];
  };
  // window value of component cp at score fs, window column fc
  auto win = [&](int cp, int fs, int fc) -> int {
    const int i = fs - s_lo - 1;
    if (i >= NS || i < -pen.D || fs < 0 || fc < 0 || fc >= W) return AW_NULL;
    return i >= 0 ? body(cp, i, fc) : head_read(cp, -1 - i, fc);
  };
  // the same, read first from the walker's tile or the one below it as
  // seen ready: a level of those is inside the planes, and a column of
  // their tiles inside the window
  auto rd = [&](int cp, int fs, int fc) -> int {
    const int i = fs - s_lo - 1;
    int rel = i - a_l0, x = fc - a_lo;
    if ((unsigned)rel < (unsigned)R && (unsigned)x < (unsigned)wc)
      return ld_shared_s32(a_base + (unsigned)((rel * 5 + cp) * kWc + x) * 4u);
    rel = i - b_l0;
    x = fc - b_lo;
    if ((unsigned)rel < (unsigned)R && (unsigned)x < (unsigned)wc)
      return ld_shared_s32(b_base + (unsigned)((rel * 5 + cp) * kWc + x) * 4u);
    return win(cp, fs, fc);
  };

  bool oob = false;
  uint8_t* op_at = ops_row + nrun;  // where the next emit goes
  int* len_at = lens_row + nrun;
  auto emit = [&](int op, int cnt) {
    if (nrun < run_cap) {
      *op_at = (uint8_t)op;
      *len_at = cnt;
    } else {
      oob = true;
    }
    ++nrun;
    ++op_at;
    ++len_at;
  };

  const int max_chunks = (3 * run_cap + 8) / kChunk + 2;
  for (int chunk = 0; chunk < max_chunks; ++chunk) {
    if (!(active && (s > s_lo || s == 0))) break;
    oob = false;
    // a walker that stops stepping changes nothing for the rest of the
    // chunk
    for (int hop = 0; hop < kChunk && active && (s > s_lo || s == 0); ++hop) {
      ++hops;
      const int cc = c - col0;
      if (s > s_lo) {
        const int t = (s - s_lo - 1) >> g.log_r;
        if (t != cur_t) {
          // entering tile t: ask for t - N + 1 .. t, those not asked yet,
          // centred on this column
          cur_t = t;
          const int new_lo = max(t - mask, 0);
          if (new_lo < req_lo) {
            const int lo = min(max(cc - kWc / 2, 0), max(W - kWc, 0));
            for (int u = min(req_lo - 1, t); u >= new_lo; --u) {
              slot_lo[u & mask] = lo;
              st_relaxed64(&req[u & mask], ((unsigned long long)(unsigned)u << 32) | (unsigned)lo);
            }
            req_lo = new_lo;
          }
          a_l0 = kNever;
          b_l0 = kNever;
        }
      }
      if (comp == 0) {
        const int mis_v = rd(0, s - pen.x, cc);
        const int cx = mis_v > AW_NULL ? mis_v + 1 : AW_NULL;
        // the four gap components at the walker's own level and column:
        // one test for all four where that is in its tile as seen ready
        int ci1, cd1, ci2, cd2;
        const int rel = s - s_lo - 1 - a_l0, x = cc - a_lo;
        if ((unsigned)rel < (unsigned)R && (unsigned)x < (unsigned)wc) {
          const unsigned at = a_base + (unsigned)(rel * 5 * kWc + x) * 4u;
          ci1 = ld_shared_s32(at + 1 * kWc * 4);
          cd1 = ld_shared_s32(at + 2 * kWc * 4);
          ci2 = ld_shared_s32(at + 3 * kWc * 4);
          cd2 = ld_shared_s32(at + 4 * kWc * 4);
        } else {
          ci1 = rd(1, s, cc);
          cd1 = rd(2, s, cc);
          ci2 = rd(3, s, cc);
          cd2 = rd(4, s, cc);
        }
        const int pre = max(max(max(cx, ci1), max(cd1, ci2)), cd2);
        int choice;
        if constexpr (FLIP) {
          choice = ci1 == pre ? 1 : cx == pre ? 0 : ci2 == pre ? 3 : cd1 == pre ? 2 : 4;
        } else {  // written as before the flip: the same instructions
          choice = cx == pre    ? 0
                   : ci1 == pre ? 1
                   : ci2 == pre ? 3
                   : cd1 == pre ? 2
                                : 4;
        }
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
        const int ev = rd(comp, s - e, is_i ? cc - 1 : cc + 1);
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
  for (int p = 0; p < n_slots; ++p) st_relaxed64(&req[p], kDone);

  walk[0 * B + b] = s;
  walk[1 * B + b] = c;
  walk[2 * B + b] = h;
  walk[3 * B + b] = comp;
  walk[4 * B + b] = active ? 1 : 0;
  nrun_p[b] = nrun;
  overflow_p[b] = overflow ? 1 : 0;
  if (stats != nullptr) {
    stats[b] = hops;
    stats[B + b] = misses;
  }
}

// The design for a walk over (NS, 5, B, W) history planes: R levels a
// tile, about a quarter of the segment and at most 32 (a 256-level
// segment is 8 tiles), N = 4 slots (three tiles below the walker's load
// while it walks), 80 KB of shared memory at R = 32 and the head.
Design choose(int NS, int W) {
  (void)W;
  return Design{tile_rows_log(NS, 5), 2};
}

}  // namespace

extern "C" {

// The walk's design for (NS, 5, B, W) history planes, as a code: bits
// 0-3 log2 of the levels a tile (R), bits 4-7 log2 of the slots (N),
// bits 8-15 the window columns a tile row covers (Wc), bits 16-19 the
// block's warps (N + 2).
int allwave_wf_traceback_design(int NS, int W) {
  const Design g = choose(NS, W);
  return g.log_r | (g.log_n << 4) | (kWc << 8) | (((1 << g.log_n) + 2) << 16);
}

// hist (NS, 5, B, W) int32; ring (P, B, K) int32, the checkpoint image at
// s_lo; c_lo (B,) int32 or null; walk (5, B) int32 rows s, c, h, comp,
// active; ops (B, run_cap) uint8; lens (B, run_cap) int32; nrun (B,)
// int32; overflow (B,) bool; stats (2, B) int32 or null: each walker's
// hops and misses of this call. design: a code of
// allwave_wf_traceback_design; flip: nonzero for the FLIP instantiation
// (test only). Updates walk and the buffers in place.
int allwave_wf_traceback(const void* hist, int NS, int B, int W,
                         const void* ring, int K, const void* c_lo, int s_lo,
                         int x, int o1, int e1, int o2, int e2, int off0,
                         int off1, int off2, int off3, int off4, int dep0,
                         int dep1, int dep2, int dep3, int dep4, int D,
                         void* walk, void* ops, void* lens, void* nrun,
                         void* overflow, int run_cap, void* stats, int design,
                         int flip, void* stream) {
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
    if (deps[i] <= 0) return (int)cudaErrorInvalidValue;
    pen.m0[i] = s_lo % deps[i];
  }
  pen.D = D;
  pen.DH = min(D, max(x, max(e1, e2)));
  const Design g{design & 15, (design >> 4) & 15};
  if (g.log_n > 3 || g.log_r > 10 || s_lo < 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_of(g, pen.DH);
  const auto kernel = flip ? wf_traceback_kernel<true> : wf_traceback_kernel<false>;
  static int allowed[2][kMaxDevices] = {};  // one record an instantiation
  cudaError_t e = allow_smem((const void*)kernel, smem, allowed[flip ? 1 : 0]);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, 32 * ((1 << g.log_n) + 2), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), NS, B, W, static_cast<const int*>(ring),
      K, static_cast<const int*>(c_lo), s_lo, pen, static_cast<int*>(walk),
      static_cast<uint8_t*>(ops), static_cast<int*>(lens),
      static_cast<int*>(nrun), static_cast<uint8_t*>(overflow), run_cap,
      static_cast<int*>(stats), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
