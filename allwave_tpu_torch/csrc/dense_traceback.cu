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
// `pack_alignments`; `dense_traceback_groups` emulates this kernel's
// schedule (its round trips included) on any device.
//
// What bounds it on an H100: latency. The plane is gigabytes (the
// headline's is 3.2 GB; L2 holds 50 MB), each hop reads one 2-byte
// entry of it, and the next hop's address depends on the entry read:
// a chain of dependent DRAM round trips per pair (~0.35 us each on one
// thread), and the longest pair sets the time. A mismatch costs two
// hops (its X cell, then the match cell after it), a gap of length L
// costs L + 2. Between round trips each hop is a few dozen dependent
// instructions of one warp, and at B = 4096 (31 warps an SM) the warps
// contend for issue, so the instructions a hop are the second cost.
// The bytes moved are tiny.
//
// Design: a warp a pair, WARPS pairs a block (B = 4096 gives 1024
// blocks over the 132 SMs). Every lane carries the same walker state and
// takes the same branches; a round trip loads, on a few lanes at once,
// the cell the walker needs now and cells it can reach from there
// before it needs another run length, each under the walk's own guard
// (1 <= d <= D2, 0 <= c < K; a cell outside reads as 0):
//
//   from an S cell (d, c):  lane 0 (d, c), lane 1 its X successor
//     (d - 2, c), lanes 2 .. 1 + NCHAIN the I chain (d - j, c - j) and
//     lanes 2 + NCHAIN .. 1 + 2 NCHAIN the D chain (d - j, c + j),
//     j = 1 .. NCHAIN;
//   from a gap cell of I (D): lane j the chain (d - j, c -+ j),
//     j = 0 .. NGAP - 1.
//
// The walker takes each cell it reaches by shuffle from the lane that
// loaded it (each lane keeps its cell's coordinates; a ballot finds the
// one the walker needs); a cell the round did not load starts the next
// round. So a mismatch costs one round trip, a gap of length <= NCHAIN
// one and a longer one (up to NGAP) two, and a gap open reads the cell
// the walker already holds. NCHAIN = 1: each speculative cell is one
// more random sector to fetch, and more of them slowed the walk on the
// card (probes/dense_split.py times NCHAIN 0, 1 and 3 side by side); 1
// keeps the most common indel, one base, at one round trip.
// Hops, the run-merge rule, the hop bound, the drops past run_cap
// (still counted in nrun), the final flush and the overflow rule are
// the XLA walk's, so the packed bytes are identical; a wrong
// speculation only costs a wasted load. Runs are built in registers
// (op codes M=0, X=1, I=2, D=3, four a byte) and written to the pair's
// row in shared memory; the warp then writes the whole row out once, 16
// bytes a lane where the rows are 16-byte aligned. A row that does not
// fit shared memory (a run cap above ~180k) is written in place in
// device memory. Optional stats: hops and round trips a pair.
//
// Output row layout, (32 + ceil(cap/4) + cap) bytes:
//   8 little-endian int32: score, nruns, cert, overflow, M, M+X, M+X+D,
//   M+X+I | ops, 2 bits each (M=0, X=1, I=2, D=3; an empty slot packs
//   as 3) | run lengths.

#include <cuda_runtime.h>
#include <stdint.h>

#define AW_INF (1 << 29)

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;               // pairs (warps) a block
constexpr int NCHAIN = 1;               // gap-chain cells an S round loads each way
constexpr int NS_LOAD = 2 + 2 * NCHAIN;  // cells an S round loads: lanes 0 .. NS_LOAD - 1
constexpr int NGAP = 8;                 // cells a gap round loads: lanes 0 .. NGAP - 1
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int PAT_S = 0, PAT_I = 1, PAT_D = 2;  // a round's pattern

__device__ __forceinline__ void put_i32(uint8_t* p, int v) {
  const unsigned u = (unsigned)v;
  p[0] = (uint8_t)(u & 0xFF);
  p[1] = (uint8_t)((u >> 8) & 0xFF);
  p[2] = (uint8_t)((u >> 16) & 0xFF);
  p[3] = (uint8_t)((u >> 24) & 0xFF);
}

// the cell lane l loads in a round of pattern p from (d, c): (d - back, c + dc)
__device__ __forceinline__ void lane_cell(int p, int l, int& back, int& dc) {
  if (p != PAT_S) {
    back = l;
    dc = p == PAT_I ? -l : l;
  } else if (l < 2) {
    back = 2 * l;
    dc = 0;
  } else if (l <= 1 + NCHAIN) {
    back = l - 1;
    dc = 1 - l;
  } else {
    back = l - 1 - NCHAIN;
    dc = back;
  }
}

// SMEM: the pair's row is staged in shared memory (row_smem bytes, a
// 16-byte multiple) and written out once; else it is written in place
template <bool SMEM>
__global__ void __launch_bounds__(32 * WARPS) dense_traceback_group_kernel(
    const uint16_t* __restrict__ planes, const int* __restrict__ scores,
    const uint8_t* __restrict__ cert, const int* __restrict__ qlens,
    const int* __restrict__ tlens, int B, int D2, int K, int run_cap, int row_smem,
    uint8_t* __restrict__ out, int* __restrict__ stats) {
  extern __shared__ __align__(16) uint8_t srows[];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wp;
  if (b >= B) return;  // the whole warp
  const int cap4 = (run_cap + 3) / 4;
  const int row_bytes = 32 + cap4 + run_cap;
  uint8_t* grow = out + (size_t)b * row_bytes;
  uint8_t* row = SMEM ? srows + (size_t)wp * row_smem : grow;
  uint8_t* ops = row + 32;
  uint8_t* lens = row + 32 + cap4;
  for (int i = 32 + lane; i < row_bytes; i += 32) row[i] = i < 32 + cap4 ? 0xFF : 0;
  __syncwarp();

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
  // the open run (op code M=0, X=1, I=2, D=3), the runs flushed, and
  // the bases of the stored runs by op
  int cur_code = 0, cur_len = 0, nrun = 0;
  bool overflow = false;
  int cnt_m = 0, cnt_x = 0, cnt_i = 0, cnt_d = 0;
  unsigned opbyte = 0xFF;  // the op codes of slots 4 (nrun / 4) .. still to store

  const size_t plane_stride = (size_t)B * K;
  const uint16_t* prow = planes + (size_t)b * K;
  // the XLA walk runs whole 32-hop chunks, at most max_chunks of them
  const int max_hops = (((2 * D2 + 8 + 31) / 32) + 1) * 32;

  // a completed run into slot nrun (< run_cap): its op code into the
  // open ops byte, stored with the byte's fourth; its length byte now
  auto store = [&](int code, int len) {
    const int sh = 2 * (nrun & 3);
    opbyte = (opbyte & ~(3u << sh)) | ((unsigned)code << sh);
    if (lane == 0) {
      lens[nrun] = (uint8_t)len;
      if (sh == 6) ops[nrun >> 2] = (uint8_t)opbyte;
    }
    if (sh == 6) opbyte = 0xFF;
    cnt_m += code == 0 ? len : 0;
    cnt_x += code == 1 ? len : 0;
    cnt_i += code == 2 ? len : 0;
    cnt_d += code == 3 ? len : 0;
  };

  int cd = -1, cc = 0;  // the cell this lane holds of the round (cd = -1: none)
  unsigned cell = 0;
  int hops = 0, rounds = 0;
  for (; hops < max_hops && active; ++hops) {
    // the lane holding (d, c), if the round loaded it; else the next round
    unsigned hit = __ballot_sync(FULL, cd == d && cc == c);
    if (hit == 0) {  // the same on every lane
      const int pat = comp == 0 ? PAT_S : ((comp & 1) ? PAT_I : PAT_D);
      int back, dc;
      lane_cell(pat, lane, back, dc);
      const bool mine = lane < (pat == PAT_S ? NS_LOAD : NGAP);
      cd = mine ? d - back : -1;
      cc = c + dc;
      cell = 0;
      if (mine && cd >= 1 && cd <= D2 && cc >= 0 && cc < K)
        cell = __ldg(prow + (size_t)(cd - 1) * plane_stride + cc);
      ++rounds;
      hit = 1;
    }
    const int v = (int)__shfl_sync(FULL, cell, __ffs(hit) - 1);
    const int byte = v & 0xFF;
    const int src = byte & 7;

    // this hop's emit (len 0: none) and move
    int code, len, nd = d, nc = c, ncomp = 0;
    if (comp == 0) {
      len = src == 0 ? max(v >> 8, 1) : (src == 1 ? 1 : 0);
      code = src;
      nd = d - 2 * len;  // a gap open stays on its cell
      ncomp = src < 2 ? 0 : (src == 2 ? 1 : (src == 4 ? 2 : (src == 3 ? 3 : 4)));
    } else {
      const bool ins = comp & 1;
      code = ins ? 2 : 3;
      len = 1;
      nd = d - 1;
      nc = ins ? c - 1 : c + 1;
      ncomp = (byte >> (comp + 2)) & 1 ? comp : 0;  // comp 1..4: bits 3..6
    }
    if (len > 0) {
      const bool same = cur_len > 0 && cur_code == code && cur_len + len <= 255;
      if (cur_len > 0 && !same) {  // flush the completed run
        if (nrun < run_cap) store(cur_code, cur_len);
        else overflow = true;
        ++nrun;
      }
      cur_len = same ? cur_len + len : len;
      cur_code = code;
    }
    if (nd <= 0) {
      active = false;
    } else {
      d = nd;
      c = nc;
      comp = ncomp;
    }
  }

  // final flush of the still-open run
  const bool has_cur = cur_len > 0;
  const bool fits = has_cur && nrun < run_cap;
  if (fits) {
    store(cur_code, cur_len);
    ++nrun;
  }
  overflow = overflow || (has_cur && !fits) || nrun > run_cap || active;
  // the last, partly filled ops byte
  const int stored = min(nrun, run_cap);
  if (lane == 0 && (stored & 3)) ops[stored >> 2] = (uint8_t)opbyte;

  const int head[8] = {score, nrun, cert[b] ? 1 : 0, overflow ? 1 : 0, cnt_m,
                       cnt_m + cnt_x, cnt_m + cnt_x + cnt_d, cnt_m + cnt_x + cnt_i};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane == i) put_i32(row + 4 * i, head[i]);
  if (stats != nullptr && lane == 0) {
    stats[b] = hops;
    stats[B + b] = rounds;
  }
  if (!SMEM) return;
  __syncwarp();
  // the row out, once: 16 bytes a lane where rows stay 16-byte aligned
  if ((row_bytes & 15) == 0 && ((uintptr_t)out & 15) == 0) {
    for (int i = lane; i < row_bytes / 16; i += 32)
      reinterpret_cast<uint4*>(grow)[i] = reinterpret_cast<const uint4*>(row)[i];
  } else if ((row_bytes & 3) == 0 && ((uintptr_t)out & 3) == 0) {
    for (int i = lane; i < row_bytes / 4; i += 32)
      reinterpret_cast<uint32_t*>(grow)[i] = reinterpret_cast<const uint32_t*>(row)[i];
  } else {
    for (int i = lane; i < row_bytes; i += 32) grow[i] = row[i];
  }
}

// bytes of a pair's row in shared memory, 0 where rows go straight to
// device memory; and the pairs a block
void layout(int run_cap, int* row_smem, int* warps) {
  const int row_bytes = 32 + (run_cap + 3) / 4 + run_cap;
  *row_smem = (row_bytes + 15) / 16 * 16;
  *warps = WARPS;
  while (*warps > 1 && *warps * *row_smem > SMEM_LIMIT) --*warps;
  if (*row_smem > SMEM_LIMIT) {
    *row_smem = 0;
    *warps = WARPS;
  }
}

}  // namespace

extern "C" {

// stats: (2, B) int32, hops and round trips a pair, or null.
int allwave_dense_traceback(const void* planes, const void* scores,
                            const void* cert, const void* qlens,
                            const void* tlens, int B, int D2, int K,
                            int run_cap, void* out, void* stats, void* stream) {
  if (B <= 0) return 0;
  if (run_cap < 1) return (int)cudaErrorInvalidValue;
  int row_smem, warps;
  layout(run_cap, &row_smem, &warps);
  const int smem = warps * row_smem;
  auto* kern = row_smem > 0 ? dense_traceback_group_kernel<true>
                            : dense_traceback_group_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + warps - 1) / warps;
  kern<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(planes), static_cast<const int*>(scores),
      static_cast<const uint8_t*>(cert), static_cast<const int*>(qlens),
      static_cast<const int*>(tlens), B, D2, K, run_cap, row_smem,
      static_cast<uint8_t*>(out), static_cast<int*>(stats));
  return (int)cudaGetLastError();
}

}  // extern "C"
