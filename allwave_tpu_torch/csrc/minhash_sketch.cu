// Orientation's stranded MinHash sets, every set of a route in one
// launch (allwave_tpu_torch/orient/device_sketch.py `stranded_sets`).
//
// Replaces no TPU kernel: the JAX package sketches on the host
// (allwave_tpu/sketch/minhash.py `sketch_stranded`, then `np.unique`,
// one set at a time in a Python loop of OrientationIndex). The port
// builds the sets here because that loop was the largest host stage of
// the cells whose card sat idle through it; the plain version is that
// same loop, taken where the index's device is the CPU.
//
// The set of a strand, bit for bit the host's: hash every k-mer window
// with Rust's DefaultHasher (SipHash-1-3, zero keys) over le64(k) ||
// window, on the raw bytes (case-sensitive); keep a window only if all
// k bytes are in ACGTacgt; a strand shorter than k has no window. Of
// the valid hashes, duplicates counted, take the smallest S
// (sketch_size) and deduplicate: with T the S-th smallest valid hash,
// the set is the distinct valid hashes <= T, or every distinct valid
// hash where there are no more than S. The reverse strand is read from
// the forward bytes, back to front, through orientation's whole-sequence
// complement (uppercase complement, N stays N, any other byte becomes
// N), so no reverse-complement bytes are built or uploaded.
//
// What bounds it on an H100: int32 operations. A window's hash is five
// SipRounds with the length prefix's round hoisted (the state after
// le64(k) is the same for every window), each round 4 64-bit adds, 4
// xors and 4 rotations, ~24 int32 instructions with 64-bit arithmetic
// emulated; the ~2 M windows of a 1,000 x 2 kb route are ~0.3 G
// operations, ~16 us at 16.73 T int32 op/s, against ~9 MB of bytes in
// and sets out (~3 us at 3.35 TB/s). Selection and deduplication are a
// few passes over the hashes a strand and do not set the pace.
//
// Design: a block of THREADS threads a strand (one launch, no host
// work a strand). The block stages TILE windows' bytes at a time in
// shared memory (complemented and reversed for the reverse strand),
// each thread hashes windows of the tile and appends the valid hashes
// by a warp vote and one shared atomic a warp. The strand's length,
// read from the offsets, picks its path:
//   short (at most `cap` windows, the wrapper's choice: a power of two
//     covering S and the longest strand of at most SHORT_MAX windows):
//     the hashes go to dynamic shared memory, a bitonic sort orders
//     them there, and the first min(S, count) are deduplicated;
//   long: the hashes go to the strand's slice of a device scratch the
//     wrapper allocates (it stays in L2 at the routes' sizes), T is
//     found by a radix select, 8 bits a pass from the top, on a
//     256-bin count histogram in shared memory, and the hashes below T
//     and T itself (at most S) are gathered into shared memory, sorted
//     and deduplicated.
// Each set is written to its row of the (sets, S) output, ascending and
// distinct, and its size beside the rows; the host copies both back at
// once. Duplicate hashes (poly-A, tandem repeats) straddling the cut
// are exact: the select counts duplicates, the gather keeps T once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;  // windows staged a pass; a multiple of THREADS
constexpr int MAX_K = 256;  // the wrapper's limit on k
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int b) {
  return (x << b) | (x >> (64 - b));
}

struct Sip13 {
  uint64_t v0, v1, v2, v3;

  __device__ __forceinline__ void round() {
    v0 += v1; v1 = rotl(v1, 13); v1 ^= v0; v0 = rotl(v0, 32);
    v2 += v3; v3 = rotl(v3, 16); v3 ^= v2;
    v0 += v3; v3 = rotl(v3, 21); v3 ^= v0;
    v2 += v1; v1 = rotl(v1, 17); v1 ^= v2; v2 = rotl(v2, 32);
  }
  __device__ __forceinline__ void compress(uint64_t m) {
    v3 ^= m;
    round();
    v0 ^= m;
  }
  __device__ __forceinline__ uint64_t finish(uint64_t b) {
    compress(b);
    v2 ^= 0xff;
    round();
    round();
    round();
    return v0 ^ v1 ^ v2 ^ v3;
  }
};

// orientation._SEQ_COMP: uppercase complement, N stays N, else N
__device__ __forceinline__ uint8_t seq_comp(uint8_t c) {
  switch (c) {
    case 'A': case 'a': return 'T';
    case 'T': case 't': return 'A';
    case 'C': case 'c': return 'G';
    case 'G': case 'g': return 'C';
    default: return 'N';
  }
}

// ACGTacgt (minhash._IS_DNA): c | 0x20 is one of acgt only for those
__device__ __forceinline__ bool is_dna(uint8_t c) {
  const uint8_t x = c | 0x20;
  return x == 'a' || x == 'c' || x == 'g' || x == 't';
}

// Append v to dst[*count] for every lane with ok (all 32 lanes call):
// one shared atomic a warp; slots past `limit` are dropped.
__device__ __forceinline__ void append(uint64_t* dst, bool ok, uint64_t v, int* count,
                                       int lane, long long limit) {
  const unsigned mask = __ballot_sync(FULL, ok);
  if (mask == 0) return;
  int at = 0;
  if (lane == 0) at = atomicAdd(count, __popc(mask));
  at = __shfl_sync(FULL, at, 0);
  const long long pos = (long long)at + __popc(mask & ((1u << lane) - 1u));
  if (ok && pos < limit) dst[pos] = v;
}

// Ascending bitonic sort of buf[0, n), n a power of two.
__device__ void bitonic_sort(uint64_t* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(THREADS)
minhash_sketch_kernel(const uint8_t* __restrict__ bytes, const int64_t* __restrict__ offs,
                      const int64_t* __restrict__ job_seq, const int64_t* __restrict__ job_rev,
                      const int64_t* __restrict__ scratch_off, uint64_t* __restrict__ scratch,
                      int k, int S, int cap, uint64_t* __restrict__ out,
                      int64_t* __restrict__ sizes) {
  extern __shared__ uint64_t buf[];  // cap entries
  __shared__ uint8_t stage[TILE + MAX_K];
  __shared__ uint32_t hist[256];
  __shared__ int s_count;
  __shared__ uint64_t s_prefix;
  __shared__ uint32_t s_rank;
  __shared__ int warp_sums[WARPS];

  const int j = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t seq = job_seq[j];
  const bool rev = job_rev[j] != 0;
  const uint8_t* base = bytes + offs[seq];
  const int64_t L = offs[seq + 1] - offs[seq];
  const int64_t nwin = L >= k ? L - k + 1 : 0;
  const bool is_long = nwin > cap;
  uint64_t* hbuf = is_long ? scratch + scratch_off[j] : buf;

  // the state after the length prefix, the same for every window
  Sip13 pre{0x736f6d6570736575ULL, 0x646f72616e646f6dULL, 0x6c7967656e657261ULL,
            0x7465646279746573ULL};
  pre.compress(static_cast<uint64_t>(k));
  const int msg_len = 8 + k;
  const int nwords = msg_len / 8;  // full words, the prefix included
  const int tail = msg_len % 8;
  const uint64_t len_hi = static_cast<uint64_t>(msg_len & 0xff) << 56;

  if (t == 0) s_count = 0;
  __syncthreads();
  for (int64_t w0 = 0; w0 < nwin; w0 += TILE) {
    const int n_tile = static_cast<int>(nwin - w0 < TILE ? nwin - w0 : TILE);
    for (int b = t; b < n_tile + k - 1; b += THREADS) {
      const int64_t p = w0 + b;
      stage[b] = rev ? seq_comp(base[L - 1 - p]) : base[p];
    }
    __syncthreads();
    for (int i = t; i < TILE; i += THREADS) {  // the same trip count on every lane
      bool ok = false;
      uint64_t h = 0;
      if (i < n_tile) {
        const uint8_t* wp = stage + i;
        Sip13 st = pre;
        bool valid = true;
        int b = 0;
#pragma unroll
        for (int wi = 1; wi < nwords; ++wi) {
          uint64_t m = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q, ++b) {
            const uint8_t c = wp[b];
            valid &= is_dna(c);
            m |= static_cast<uint64_t>(c) << (8 * q);
          }
          st.compress(m);
        }
        uint64_t m = len_hi;
#pragma unroll
        for (int q = 0; q < tail; ++q, ++b) {
          const uint8_t c = wp[b];
          valid &= is_dna(c);
          m |= static_cast<uint64_t>(c) << (8 * q);
        }
        if (valid) {
          h = st.finish(m);
          ok = true;
        }
      }
      append(hbuf, ok, h, &s_count, lane, nwin);
    }
    __syncthreads();
  }
  const int n_valid = s_count;

  int cnt;  // values in buf[0, cnt)
  int m;    // the sorted prefix deduplicated
  if (!is_long) {
    cnt = n_valid;
    m = n_valid < S ? n_valid : S;
  } else if (n_valid <= S) {
    for (int i = t; i < n_valid; i += THREADS) buf[i] = hbuf[i];
    cnt = m = n_valid;
  } else {
    // radix select of the S-th smallest, duplicates counted: the bits
    // above `shift` are fixed to `prefix`, `rank` counts within them
    uint64_t prefix = 0;
    uint32_t rank = static_cast<uint32_t>(S);
    for (int shift = 56; shift >= 0; shift -= 8) {
      const uint64_t hi_mask = shift == 56 ? 0 : ~0ULL << (shift + 8);
      for (int i = t; i < 256; i += THREADS) hist[i] = 0;
      __syncthreads();
      for (int i = t; i < n_valid; i += THREADS) {
        const uint64_t v = hbuf[i];
        if ((v & hi_mask) == prefix) atomicAdd(&hist[(v >> shift) & 0xff], 1u);
      }
      __syncthreads();
      if (warp == 0) {
        uint32_t c[8], sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = hist[lane * 8 + q];
          sum += c[q];
        }
        uint32_t incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t y = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += y;
        }
        uint32_t run = incl - sum;
        if (run < rank && rank <= incl) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (run < rank && rank <= run + c[q]) {
              s_prefix = prefix | (static_cast<uint64_t>(lane * 8 + q) << shift);
              s_rank = rank - run;
            }
            run += c[q];
          }
        }
      }
      __syncthreads();
      prefix = s_prefix;
      rank = s_rank;
    }
    const uint64_t T = prefix;
    if (t == 0) s_count = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n_valid; i0 += THREADS) {
      const int i = i0 + t;
      const uint64_t v = i < n_valid ? hbuf[i] : 0;
      append(buf, i < n_valid && v < T, v, &s_count, lane, S - 1);
    }
    __syncthreads();
    // fewer than S hashes lie below T; the clamp only keeps a fault
    // inside the buffer
    cnt = m = (s_count < S - 1 ? s_count : S - 1) + 1;
    if (t == 0) buf[cnt - 1] = T;
  }

  int n_sort = 1;
  while (n_sort < cnt) n_sort <<= 1;
  for (int i = cnt + t; i < n_sort; i += THREADS) buf[i] = ~0ULL;
  __syncthreads();
  bitonic_sort(buf, n_sort);

  // the distinct values of buf[0, m), in order
  uint64_t* row = out + static_cast<int64_t>(j) * S;
  int total = 0;
  for (int i0 = 0; i0 < m; i0 += THREADS) {
    const int i = i0 + t;
    const bool first = i < m && (i == 0 || buf[i] != buf[i - 1]);
    const unsigned mask = __ballot_sync(FULL, first);
    if (lane == 0) warp_sums[warp] = __popc(mask);
    __syncthreads();
    int before = total, chunk = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += warp_sums[w];
      chunk += warp_sums[w];
    }
    if (first) row[before + __popc(mask & ((1u << lane) - 1u))] = buf[i];
    total += chunk;
    __syncthreads();
  }
  if (t == 0) sizes[j] = total;
}

}  // namespace

extern "C" {

// bytes: the jobs' sequences, concatenated; offs: (n + 1) int64 offsets
// into them; job_seq, job_rev, scratch_off: (J,) int64, a job's
// sequence, 1 for its reverse strand, and its slice of `scratch` where
// it has more than `cap` windows; out: (J, S) uint64 sets; sizes: (J,)
// int64. cap: a power of two >= S, the shared-memory entries a block.
int allwave_minhash_sketch(const void* bytes, const void* offs, const void* job_seq,
                           const void* job_rev, const void* scratch_off, void* scratch, int J,
                           int k, int S, int cap, void* out, void* sizes, void* stream) {
  if (J <= 0) return 0;
  if (k < 1 || k > MAX_K || S < 1 || cap < S || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  auto* kern = minhash_sketch_kernel;
  const int smem = cap * static_cast<int>(sizeof(uint64_t));
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<J, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int64_t*>(offs),
      static_cast<const int64_t*>(job_seq), static_cast<const int64_t*>(job_rev),
      static_cast<const int64_t*>(scratch_off), static_cast<uint64_t*>(scratch), k, S, cap,
      static_cast<uint64_t*>(out), static_cast<int64_t*>(sizes));
  return (int)cudaGetLastError();
}

}  // extern "C"
