// The tiers of the batched wavefront forward (csrc/wf_batch.cu): which
// design a band of K lanes runs for B pairs, from the compact rings'
// rows, the card's shared memory a block and its SM count. Plain C++
// with no CUDA in it, so the same table is compiled into the kernel
// library and, by the host compiler, into the CPU tests
// (tests/test_torch_wf_batch_design.py).
//
//   block    one block a pair, the pair's rings in its shared memory:
//            where one block holds K lanes' rings and the batch fills
//            the card (B >= the SM count) or the band is too narrow to
//            split (K <= TIER_MIN_LB);
//   cluster  a thread-block cluster of G <= 16 blocks a pair, block r
//            the lanes [r Lb, (r + 1) Lb) and their rings: where one
//            block does not hold the band's rings, or a small batch
//            spreads over ceil(K / TIER_MIN_LB) blocks a pair;
//   global   one block a pair, the rings in device memory: only where
//            16 blocks do not hold the band's rings.

#ifndef ALLWAVE_WF_BATCH_TIERS_CUH
#define ALLWAVE_WF_BATCH_TIERS_CUH

namespace wf_batch_tiers {

constexpr int TIER_BLOCK = 0, TIER_CLUSTER = 1, TIER_GLOBAL = 2;
constexpr int TIER_MIN_LB = 256;     // lanes a block before a small batch's band spreads
constexpr int TIER_MAX_LB = 4096;    // the most lanes a block: 4 a thread
constexpr int TIER_MAX_THREADS = 1024;
constexpr int TIER_PORTABLE_G = 8;   // the portable cluster size
constexpr int TIER_MAX_G = 16;       // the largest (non-portable) one

// rows of a block's rings: M keeps D levels, I1 and D1 e1 + 1, I2 and
// D2 (two-piece only) e2 + 1
inline int ring_rows(int D, int e1, int e2, int two_piece) {
  return D + 2 * (e1 + 1) + (two_piece ? 2 * (e2 + 1) : 0);
}

// shared memory of a block of Lb lanes: each ring row has a NULL slot
// on either side of the lanes, then the done stamp (16 bytes), then
// (staged) the pair's two sequence rows from a 16-byte boundary
inline long long ring_smem(int Lb, int rows) { return 4LL * rows * (Lb + 2) + 16; }

inline long long block_smem(int Lb, int rows, long long staged_bytes) {
  return (ring_smem(Lb, rows) + 15) / 16 * 16 + staged_bytes;
}

inline int lanes_per_thread(int Lb) { return (Lb + TIER_MAX_THREADS - 1) / TIER_MAX_THREADS; }

inline int block_threads(int Lb) {
  const int lpt = lanes_per_thread(Lb);
  return ((Lb + lpt - 1) / lpt + 31) / 32 * 32;
}

inline bool block_fits(int Lb, int rows, int smem) {
  return Lb >= 1 && Lb <= TIER_MAX_LB && ring_smem(Lb, rows) <= smem;
}

// a design as a code: bits 0-1 the tier, bit 2 whether the sequences
// are staged in shared memory, 3-7 the blocks a pair G, 8-11 the lanes a
// thread, 12 and up the lanes a block Lb
inline int tier_code(int tier, int G, int Lb, int staged = 0) {
  return tier | (staged << 2) | (G << 3) | (lanes_per_thread(Lb) << 8) | (Lb << 12);
}

// the least G in [from, maxg] whose blocks of ceil(K / G) lanes fit,
// as a code (G recounted as the blocks those lanes need), or -1
inline int cluster_code(int K, int rows, int smem, int from, int maxg) {
  for (int G = from < 2 ? 2 : from; G <= maxg; ++G) {
    const int Lb = (K + G - 1) / G;
    if (block_fits(Lb, rows, smem)) return tier_code(TIER_CLUSTER, (K + Lb - 1) / Lb, Lb);
  }
  return -1;
}

// with the staging bit set where a block of the design's lanes also
// holds the two sequence rows of l_pad bytes: the extension then reads
// shared memory, not L1 or L2
inline int staged_code(int code, int rows, int l_pad, int smem) {
  return block_smem(code >> 12, rows, 2LL * l_pad) <= smem ? code | 4 : code;
}

// The tier a band of K lanes takes for B pairs of sequence rows of l_pad
// bytes, on a card with `smem` bytes of shared memory a block and n_sm
// SMs, with the cluster's least G (up to maxg blocks; the card's
// occupancy may then prefer another candidate, csrc/wf_batch.cu
// `choose`). The tier depends on the rings alone; staging the sequences
// is added where they fit beside them. -1 for K < 1, rows < 1 or
// l_pad < 0.
inline int tier_of(int K, int B, int l_pad, int rows, int smem, int n_sm, int maxg) {
  if (K < 1 || rows < 1 || l_pad < 0) return -1;
  const bool spread = B < n_sm && K > TIER_MIN_LB;
  if (block_fits(K, rows, smem) && !spread)
    return staged_code(tier_code(TIER_BLOCK, 1, K), rows, l_pad, smem);
  int want = (K + TIER_MIN_LB - 1) / TIER_MIN_LB;
  want = spread ? (want < maxg ? want : maxg) : 2;
  const int code = cluster_code(K, rows, smem, want, maxg);
  if (code >= 0) return staged_code(code, rows, l_pad, smem);
  return tier_code(TIER_GLOBAL, 1, 0);
}

}  // namespace wf_batch_tiers

extern "C" {

// The tier table alone (see tier_of) for the rings of D = max lookback
// + 1, e1 and e2 (two_piece), with clusters of up to 16 blocks: the
// same code the forward's dispatch starts from.
int allwave_wf_batch_tier(int K, int B, int l_pad, int D, int e1, int e2, int two_piece,
                          int smem, int n_sm) {
  return wf_batch_tiers::tier_of(K, B, l_pad, wf_batch_tiers::ring_rows(D, e1, e2, two_piece),
                                 smem, n_sm, wf_batch_tiers::TIER_MAX_G);
}

}  // extern "C"

#endif  // ALLWAVE_WF_BATCH_TIERS_CUH
