// Golomb wire packers for Hopper: the two Pallas kernels of the JAX
// package's src/repro/kernels/pack.py.
//
//   seg_packbits     <- seg_packbits    (_packbits_kernel)
//   seg_select_pack  <- seg_select_pack (_select_pack_kernel)
//
// Bit layout (the byte contract with the host Golomb encoder): stream bit
// b lives in word b >> 5 at bit position 31 - (b & 31), so the words read
// big-endian are np.packbits of the stream.  Per selected slot the
// codeword is q = (gap - 1) >> b* ones, a 0, then the b* low bits of
// gap - 1, most significant first.
//
// seg_packbits: planes u32[32, nwords] (plane j holds bit j of every
// word) -> words u32[nwords].  One thread per word ORs its 32 plane
// entries; neighbouring threads read neighbouring words of a plane, so
// every load is coalesced.  It moves 33 words per output word and does 64
// integer operations, so it is bound by bytes; at the exact engine's
// 3,456 words that is 0.46 MB, about 0.14 us at 3.35 TB/s, far below the
// cost of a launch.
//
// seg_select_pack: mask int32[rows, n] (0/1, k set slots per row) ->
// words u32[rows, W] and nbits int32[rows].  The TPU kernel builds a
// row's whole bit stream in VMEM and folds it; here one CTA owns a row
// and walks it in chunks of kThreads * kItems slots:
//   * each warp reads its part of the chunk 32 slots at a time, coalesced,
//     and __ballot_sync turns every 32 into one selection word, which lane
//     v keeps for the v-th 32; so each thread owns 32 consecutive slots,
//     in slot order, as one 32-bit word;
//   * a block-wide max-scan of each thread's last selected position
//     gives the position of the selected slot before each thread's
//     first one (so its gap), then a block-wide sum-scan of (count, sum
//     of q) gives each selected slot its rank and its codeword's start:
//     start_r = sum_{s<r} q_s + r * (1 + b*);
//   * each codeword's bits are ORed into the row's words with atomicOr.
//     OR is order-free, so the words do not depend on which thread runs
//     first: the result is deterministic.
// The CTA zeroes its row's words first, and the thread that writes the
// k-th codeword writes nbits (its start plus its length).  Selected slots
// past the k-th are dropped, as the reference's scatter drops them; a row
// with fewer than k gets nbits = -1.  Bits at or past the row's capacity
// (32 * W) are dropped, as the reference's mode="drop" scatter does; with
// k set slots that never happens.
//
// What bounds it on an H100: it reads the mask once (4 bytes a slot), so
// bytes bound it; LeNet5's f1 row (1,225,000 slots) is 4.9 MB, about
// 1.5 us at 3.35 TB/s.  One CTA per row runs on one SM, so a long row is
// far from that bound: it waits on memory latency, with one SM's loads in
// flight.  Splitting a row across CTAs is later work.  The loads are
// coalesced because a thread that read its own 32 slots would make every
// warp load touch 32 cache lines.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int kPackThreads = 256;

// grid = ceil(nwords / kPackThreads), block = kPackThreads.
__global__ void __launch_bounds__(kPackThreads)
seg_packbits_kernel(const uint32_t* __restrict__ planes, uint32_t* __restrict__ words,
                    int nwords) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwords) return;
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc |= planes[(size_t)j * nwords + w] << (31 - j);
  words[w] = acc;
}

constexpr int kThreads = 1024;
constexpr int kItems = 32;  // consecutive slots a thread owns per chunk (one bit each)

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

struct SumOp {
  __device__ __forceinline__ int2 operator()(int2 a, int2 b) const {
    return make_int2(a.x + b.x, a.y + b.y);
  }
};

// OR ones into stream bits [pos, pos + len), dropping bits at or past cap.
__device__ __forceinline__ void or_ones(uint32_t* row, int cap, int pos, int len) {
  const int end = min(pos + len, cap);
  while (pos < end) {
    const int off = pos & 31;
    const int take = min(32 - off, end - pos);
    const uint32_t bits = take == 32 ? 0xffffffffu : ((1u << take) - 1u) << (32 - off - take);
    atomicOr(&row[pos >> 5], bits);
    pos += take;
  }
}

// OR the nb-bit field `value` (1 <= nb <= 30), most significant bit first,
// into stream bits [pos, pos + nb), dropping words at or past cap / 32
// (cap is a whole number of words).
__device__ __forceinline__ void or_field(uint32_t* row, int cap, int pos, uint32_t value,
                                         int nb) {
  const int word = pos >> 5;
  const int off = pos & 31;
  const int first = min(nb, 32 - off);  // bits that go into the first word
  if (pos < cap) atomicOr(&row[word], (value >> (nb - first)) << (32 - off - first));
  const int rest = nb - first;
  if (rest > 0 && (word + 1) * 32 < cap) {
    atomicOr(&row[word + 1], (value & ((1u << rest) - 1u)) << (32 - rest));
  }
}

// grid = rows, block = kThreads.  row_words = W words per row.  Positions,
// counts and stream bits fit in int: the wrapper checks n and 32 * W
// against 2^31.
__global__ void __launch_bounds__(kThreads)
seg_select_pack_kernel(const int* __restrict__ mask, uint32_t* __restrict__ words,
                       int* __restrict__ nbits_out, int n, int k, int bstar,
                       int row_words) {
  using MaxScan = cub::BlockScan<int, kThreads>;
  using SumScan = cub::BlockScan<int2, kThreads>;
  __shared__ union {
    typename MaxScan::TempStorage max;
    typename SumScan::TempStorage sum;
  } tmp;

  const int row = blockIdx.x;
  const int* m = mask + (size_t)row * n;
  uint32_t* out = words + (size_t)row * row_words;
  const int cap = 32 * row_words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < row_words; i += kThreads) out[i] = 0u;
  if (k == 0 && threadIdx.x == 0) nbits_out[row] = 0;
  __syncthreads();  // the zeroed words are visible to every thread's atomicOr

  // identical in every thread: selected slots, sum of q, and the position
  // of the last selected slot, over all chunks before this one
  int carry_rank = 0, carry_q = 0, carry_last = -1;
  for (int base = 0; base < n && carry_rank < k; base += kThreads * kItems) {
    // warp w reads its chunk's slots [base + 1024 w, base + 1024 (w + 1))
    // 32 at a time, coalesced; lane v keeps the ballot of the v-th 32, so
    // thread (w, v) owns the 32 consecutive slots from `lo`, and thread
    // order is slot order
    const int wbase = base + warp * 32 * kItems;
    uint32_t sel = 0u;
#pragma unroll 8
    for (int v = 0; v < kItems; ++v) {
      const int i = wbase + v * 32 + lane;
      const uint32_t b = __ballot_sync(0xffffffffu, i < n && m[i] != 0);
      if (lane == v) sel = b;
    }
    const int lo = wbase + lane * kItems;
    const int last = sel ? lo + 31 - __clz(sel) : -1;

    int prev, chunk_last;
    MaxScan(tmp.max).ExclusiveScan(last, prev, carry_last, MaxOp(), chunk_last);
    __syncthreads();

    // the unary length q of each of this thread's codewords, summed
    int qsum = 0;
    {
      int p_prev = prev;
      uint32_t s = sel;
      while (s) {
        const int p = lo + (__ffs(s) - 1);
        s &= s - 1u;
        qsum += (p - p_prev - 1) >> bstar;
        p_prev = p;
      }
    }
    int2 before, chunk_total;
    SumScan(tmp.sum).ExclusiveScan(make_int2(__popc(sel), qsum), before, make_int2(0, 0),
                                   SumOp(), chunk_total);
    __syncthreads();

    int rank = carry_rank + before.x;
    int qbase = carry_q + before.y;
    int p_prev = prev;
    uint32_t s = sel;
    while (s && rank < k) {
      const int p = lo + (__ffs(s) - 1);
      s &= s - 1u;
      const int dm1 = p - p_prev - 1;
      const int q = dm1 >> bstar;
      const int start = qbase + rank * (1 + bstar);
      or_ones(out, cap, start, q);
      if (bstar) or_field(out, cap, start + q + 1, (uint32_t)dm1 & ((1u << bstar) - 1u), bstar);
      if (rank == k - 1) nbits_out[row] = start + q + 1 + bstar;
      qbase += q;
      ++rank;
      p_prev = p;
    }
    carry_rank += chunk_total.x;
    carry_q += chunk_total.y;
    carry_last = max(carry_last, chunk_last);
  }
  if (carry_rank < k && threadIdx.x == 0) nbits_out[row] = -1;
}

}  // namespace

// ---------------------------------------------------------------- C API
// Plain C entry points for ctypes.  Each launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (0 = cudaSuccess) so a refused launch is reported to the wrapper.

extern "C" int seg_packbits_launch(const void* planes, void* words, int nwords,
                                   void* stream) {
  if (nwords > 0) {
    seg_packbits_kernel<<<(nwords + kPackThreads - 1) / kPackThreads, kPackThreads, 0,
                          (cudaStream_t)stream>>>((const uint32_t*)planes,
                                                  (uint32_t*)words, nwords);
  }
  return (int)cudaGetLastError();
}

extern "C" int seg_select_pack_launch(const void* mask, void* words, void* nbits, int rows,
                                      int n, int k, int bstar, int row_words,
                                      void* stream) {
  if (rows > 0) {
    seg_select_pack_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)mask, (uint32_t*)words, (int*)nbits, n, k, bstar, row_words);
  }
  return (int)cudaGetLastError();
}
