// Golomb wire packers for Hopper: the two Pallas kernels of the JAX
// package's src/repro/kernels/pack.py.
//
//   seg_packbits         <- seg_packbits    (_packbits_kernel), bit planes
//   seg_packbits_stream  <- seg_packbits, on stream-order bits (the
//                           reference's pack_bit_rows in one launch)
//   seg_select_pack      <- seg_select_pack (_select_pack_kernel)
//
// Bit layout (the byte contract with the host Golomb encoder): stream bit
// b lives in word b >> 5 at bit position 31 - (b & 31), so the words read
// big-endian are np.packbits of the stream.  Per selected slot the
// codeword is q = (gap - 1) >> b* ones, a 0, then the b* low bits of
// gap - 1, most significant first.  Both packers place bit j of a word
// with place_bit (a u32 value shifted left by 31 - j, bits shifted past
// bit 31 lost, as in the reference's 32-bit shift-and-OR).
//
// seg_packbits: planes u32[32, nwords] (plane j holds bit j of every
// word) -> words u32[nwords].  The layout exists because Pallas works in
// (32, lanes) blocks.  One thread per word ORs its 32 plane entries;
// neighbouring threads read neighbouring words of a plane, so every load
// is coalesced.  Bound by bytes (33 words moved per word).
//
// seg_packbits_stream: bits u32[nbits] in stream order -> words
// u32[ceil(nbits / 32)], so the exact path needs neither the pad to whole
// (32, lanes) blocks nor the transpose that the planes want.  One warp
// builds 32 words: in step j lane i loads bit 32 (w0 + j) + i, one
// coalesced 128-byte line per step and 32 loads in flight per lane, and
// __reduce_or_sync of the lanes' placed bits is word w0 + j, which lane j
// keeps; the 32 lanes then store 32 consecutive words.  The ragged last
// word group is masked in the kernel (bits past nbits are 0).  It moves
// 33 words per word, so it is bound by bytes: the exact engine's 3,358
// words are 0.44 MB, 0.13 us at 3.35 TB/s, below the cost of a launch.
//
// seg_select_pack: mask int32[rows, n] (0/1, k set slots per row) ->
// words u32[rows, W] and nbits int32[rows], in ONE launch.  It reads the
// mask once (4 bytes a slot): bound by bytes, LeNet5's f1 row (1,225,000
// slots) is 4.91 MB, 1.47 us at 3.35 TB/s.  A row that one CTA walks
// waits on one SM's memory latency, so here a row is cut into tiles of
// kTileSlots = 8,192 slots (f1: 150 tiles) and the tiles of all rows are
// spread over a persistent grid of at most one wave (G = SMs x resident
// CTAs, at most the number of tiles; the wrapper passes it):
//   * a CTA takes tiles in order from an atomic counter, so every tile
//     before the one it holds was taken by a running CTA: a tile never
//     waits on a tile that has not started.  When there are no more tiles
//     than CTAs, each CTA takes one and does not ask again;
//   * each warp reads its 1,024 slots with 8 coalesced 16-byte loads a
//     lane, all in flight at once, and segmented shuffles turn them into
//     one selection word per 32 slots, which lane v keeps for the v-th 32:
//     thread order is slot order.  A block max-scan gives each thread the
//     selected slot before its first, a block sum-scan its rank in the
//     tile and the unary lengths before it;
//   * a single-pass scan across the tiles of a row (decoupled look-back):
//     a tile's state is (count, first selected position, last selected
//     position, sum of q of its codewords after its first).  Two states
//     combine associatively; the codeword that joins A and B has
//     q = (first_B - last_A - 1) >> b*, and a row's first codeword
//     counts from position -1.  The tile publishes its aggregate, warp 0
//     reads up to 256 predecessors at once and folds them back to the
//     nearest inclusive prefix (or the row's start), and the tile
//     publishes its own.  A state is all integers, so the result does not
//     depend on which CTA runs when;
//   * from its exclusive prefix the tile knows its first codeword's rank
//     r0 and start, start_r = sum_{s<r} q_s + r (1 + b*), so its
//     codewords cover one contiguous range of stream bits, starting with
//     the unary run of its first codeword (which may have begun in empty
//     tiles: it belongs to this tile).  The codewords after that run are
//     ORed into shared memory (shared atomics; their bits stay within
//     (T >> b*) + T (1 + b*) + 63 bits), then every word wholly inside
//     the range is a plain coalesced store and the partial words at its
//     two ends go to the tile's slot of the workspace;
//   * the thread that writes the k-th codeword writes nbits.  The last
//     CTA (a ticket: atomicInc that wraps to 0) ORs the partial words
//     into their words, zeroes each row's words past its last codeword,
//     writes nbits = -1 for a row with fewer than k set slots (and 0 when
//     k = 0), and leaves every workspace word it used at zero.
// So the output needs no memset and no atomics from other CTAs.  Selected
// slots past the k-th are dropped, as the reference's scatter drops them.
// Bits at or past the row's capacity (32 * W) are dropped, as the
// reference's mode="drop" scatter does; with k set slots that never
// happens.  On f1 the time past the bytes is latency: the look-back
// (reads of states that other SMs have just written, and the fold), the
// codewords' emission, the ticket and the last CTA's round trips.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

// Bit j of a word (most significant first) from the u32 value v.
__device__ __forceinline__ uint32_t place_bit(uint32_t v, int j) { return v << (31 - j); }

constexpr int kPackThreads = 256;

// grid = ceil(nwords / kPackThreads), block = kPackThreads.
__global__ void __launch_bounds__(kPackThreads)
seg_packbits_kernel(const uint32_t* __restrict__ planes, uint32_t* __restrict__ words,
                    int nwords) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwords) return;
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc |= place_bit(planes[(size_t)j * nwords + w], j);
  words[w] = acc;
}

constexpr int kStreamThreads = 128;  // 4 warps, 128 words a CTA

// grid = ceil(nwords / kStreamThreads), block = kStreamThreads.
__global__ void __launch_bounds__(kStreamThreads)
seg_packbits_stream_kernel(const uint32_t* __restrict__ bits, uint32_t* __restrict__ words,
                           int nbits) {
  const int nwords = (int)(((long long)nbits + 31) >> 5);
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * (kStreamThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (w0 >= nwords) return;  // the whole warp
  uint32_t v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const long long b = 32LL * (w0 + j) + lane;
    v[j] = b < nbits ? bits[b] : 0u;
  }
  uint32_t mine = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t w = __reduce_or_sync(0xffffffffu, place_bit(v[j], lane));
    if (lane == j) mine = w;
  }
  if (w0 + lane < nwords) words[w0 + lane] = mine;
}

constexpr int kThreads = 256;
constexpr int kItems = 32;                     // slots a thread owns in a tile
constexpr int kTileSlots = kThreads * kItems;  // 8,192 (kernels/pack.py TILE_SLOTS)
// workspace, in 16-byte entries: [0] the tile counter and the ticket (two
// 32-bit words, then padding), then three arrays over the tiles in order:
// aggregates, inclusive prefixes and pieces (head, tail); then one 32-bit
// count per row of the tiles that have published.  A state is two
// 64-bit halves, each with a valid bit (bit 63) and each written once per
// launch as one 64-bit value: a reader that sees both halves valid has the
// whole state, with no fence and no flag.  A piece is (word + 1) << 32 |
// bits, 0 when there is none.  A warp reads 32 neighbouring tiles' states
// in 4 cache lines.
constexpr unsigned long long kValid = 1ull << 63;

// Shared-memory words a tile's codewords after its first unary run need.
__host__ __device__ __forceinline__ int tile_smem_words(int bstar) {
  return (kTileSlots * (1 + bstar) + (kTileSlots >> bstar) + 63) / 32 + 1;
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

struct SumOp {
  __device__ __forceinline__ int2 operator()(int2 a, int2 b) const {
    return make_int2(a.x + b.x, a.y + b.y);
  }
};

// A run of tiles: c selected slots, the first at f and the last at l,
// and sq, the sum of q of its codewords after its first.
struct TileState {
  int c, f, l, sq;
};

__device__ __forceinline__ TileState empty_state() { return {0, -1, -1, 0}; }

// The state of A followed by B.
__device__ __forceinline__ TileState combine(TileState a, TileState b, int bstar) {
  if (a.c == 0) return b;
  if (b.c == 0) return a;
  return {a.c + b.c, a.f, b.l, a.sq + b.sq + ((b.f - a.l - 1) >> bstar)};
}

__device__ __forceinline__ TileState shfl_down(TileState s, int off) {
  return {__shfl_down_sync(0xffffffffu, s.c, off), __shfl_down_sync(0xffffffffu, s.f, off),
          __shfl_down_sync(0xffffffffu, s.l, off), __shfl_down_sync(0xffffffffu, s.sq, off)};
}

// c, f + 1, l + 1 and sq are in [0, 2^31): the wrapper checks n.
__device__ __forceinline__ void store_state(ulonglong2* p, TileState s) {
  const unsigned long long h0 = kValid | (unsigned long long)(unsigned)s.c << 32 | (unsigned)s.sq;
  const unsigned long long h1 =
      kValid | (unsigned long long)(unsigned)(s.f + 1) << 32 | (unsigned)(s.l + 1);
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(h0), "l"(h1));
}

__device__ __forceinline__ ulonglong2 load_halves(const ulonglong2* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ bool whole(ulonglong2 h) { return (h.x & h.y & kValid) != 0; }

__device__ __forceinline__ TileState unpack_state(ulonglong2 h) {
  return {(int)((h.x >> 32) & 0x7fffffffu), (int)((h.y >> 32) & 0x7fffffffu) - 1,
          (int)(unsigned)h.y - 1, (int)(unsigned)h.x};
}

constexpr int kLook = 8;  // predecessors a lane loads at once: 256 a warp
constexpr int kLookSh = 32 * kLook + 32;  // entries of one state array in shared memory

// Where entry e of a window lives in shared memory: one entry of padding
// after every 8, so that lanes that read entries 8 apart (8 l + k) and
// lanes that write neighbouring entries (32 i + l) hit different banks.
__device__ __forceinline__ int skew(int e) { return e + (e >> 3); }

// Warp 0: the exclusive prefix of tile j of a row whose aggregates and
// inclusive prefixes start at `agg` and `incl`.  First lane 0 waits until
// at least j tiles of the row have published (one lane reads a count, so
// the tiles do not read each other's states while few are there).  A
// window is the 256 tiles base - e, e = 32 i + lane, i < kLook: each lane
// loads its kLook tiles' two states at once (coalesced), and again at once
// those of its tiles that have neither yet, then puts them in shared
// memory `sh` (2 arrays of kLookSh entries).  Lane l then walks e = 8 l + 7 .. 8 l,
// earliest first, taking a tile's inclusive prefix where both its halves
// are there (and starting its fold again from it), else its aggregate; the
// row's start counts as an inclusive prefix.  The nearest inclusive prefix
// of the window ends it: lanes past it count as empty, and the warp folds
// the 32 lanes (a higher lane is earlier).  A row of up to 256 tiles needs
// one window.
__device__ TileState look_back(const ulonglong2* agg, const ulonglong2* incl,
                               const unsigned* published, int j, int bstar, int lane,
                               ulonglong2* sh) {
  if (lane == 0) {
    while (*(const volatile unsigned*)published < (unsigned)j) __nanosleep(32);
  }
  __syncwarp();
  TileState excl = empty_state();
  for (int base = j - 1;; base -= 32 * kLook) {
    ulonglong2 hi[kLook] = {}, ha[kLook] = {};
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      const int jj = base - 32 * i - lane;
      if (jj >= 0) {
        hi[i] = load_halves(incl + jj);
        ha[i] = load_halves(agg + jj);
      }
    }
    // a tile that has neither state yet: all such are loaded again at once
    for (;;) {
      bool missing = false;
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const int jj = base - 32 * i - lane;
        if (jj >= 0 && !whole(hi[i]) && !whole(ha[i])) {
          hi[i] = load_halves(incl + jj);
          ha[i] = load_halves(agg + jj);
          missing = true;
        }
      }
      if (!missing) break;
    }
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      sh[skew(32 * i + lane)] = hi[i];
      sh[kLookSh + skew(32 * i + lane)] = ha[i];
    }
    __syncwarp();
    TileState s = empty_state();
    int nearest = 32 * kLook;  // this lane's nearest inclusive prefix
#pragma unroll 1
    for (int e = kLook * lane + kLook - 1; e >= kLook * lane; --e) {
      const int jj = base - e;
      if (jj < 0) {
        s = empty_state();
        nearest = e;
        continue;
      }
      const ulonglong2 h = sh[skew(e)], a = sh[kLookSh + skew(e)];
      if (whole(h)) {
        s = unpack_state(h);
        nearest = e;
      } else {
        s = combine(s, unpack_state(a), bstar);
      }
    }
    const int stop = (int)__reduce_min_sync(0xffffffffu, (unsigned)nearest);
    if (kLook * lane > stop) s = empty_state();
#pragma unroll 1
    for (int off = 1; off < 32; off <<= 1) {
      const TileState o = shfl_down(s, off);
      if ((lane & (2 * off - 1)) == 0 && lane + off < 32) s = combine(o, s, bstar);
    }
    s = {__shfl_sync(0xffffffffu, s.c, 0), __shfl_sync(0xffffffffu, s.f, 0),
         __shfl_sync(0xffffffffu, s.l, 0), __shfl_sync(0xffffffffu, s.sq, 0)};
    excl = combine(s, excl, bstar);
    if (stop < 32 * kLook) return excl;
    __syncwarp();  // sh is read by all lanes before the next window
  }
}

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

// Called by every thread once the CTA's writes are issued: true in the CTA
// that finishes last, after which that CTA sees every other CTA's writes.
// The ticket counts finished CTAs and wraps to 0 by itself.
__device__ __forceinline__ bool last_cta(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// The selection word of the 32 slots [lo, lo + 32) of this lane (bit i is
// slot lo + i), for the 1,024 slots [wbase, wbase + 1024) of its warp.
// Group g (128 slots) is read with one 16-byte load a lane (lane l: slots
// 4l .. 4l + 3), coalesced, all 8 loads in flight; each lane's 4 flags
// are ORed across its 8-lane segment into a 32-slot word, which lane
// 4g + w takes from lane 8w.  A tile that ends past n, or a row that is
// not 16-byte aligned, takes 4 guarded scalar loads per lane instead.
__device__ __forceinline__ uint32_t select_word(const int* m, int n, int wbase, int lane,
                                                bool vec) {
  int4 v[8];
  if (vec) {
    const int4* m4 = reinterpret_cast<const int4*>(m + wbase) + lane;
#pragma unroll
    for (int g = 0; g < 8; ++g) v[g] = __ldcs(m4 + 32 * g);
  } else {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int i = wbase + 128 * g + 4 * lane;
      v[g] = make_int4(i < n ? m[i] : 0, i + 1 < n ? m[i + 1] : 0, i + 2 < n ? m[i + 2] : 0,
                       i + 3 < n ? m[i + 3] : 0);
    }
  }
  uint32_t sel = 0u;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    uint32_t x = ((uint32_t)(v[g].x != 0) | (uint32_t)(v[g].y != 0) << 1
                  | (uint32_t)(v[g].z != 0) << 2 | (uint32_t)(v[g].w != 0) << 3)
                 << (4 * (lane & 7));
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    x |= __shfl_xor_sync(0xffffffffu, x, 4);
    x = __shfl_sync(0xffffffffu, x, 8 * (lane & 3));
    if ((lane >> 2) == g) sel = x;
  }
  return sel;
}

// grid = G persistent CTAs, block = kThreads, dynamic shared memory
// tile_smem_words(bstar) words.  ws: 4 + 12 * rows * tiles_per_row + rows
// int32, 16-byte aligned, zero on entry and left zero.  Positions, counts and
// stream bits fit in int: the wrapper checks n and 32 * W against 2^31.
__global__ void __launch_bounds__(kThreads)
seg_select_pack_kernel(const int* __restrict__ mask, uint32_t* __restrict__ words,
                       int* __restrict__ nbits_out, int* __restrict__ ws, int rows, int n,
                       int k, int bstar, int row_words, int tiles_per_row) {
  using MaxScan = cub::BlockScan<int, kThreads>;
  using SumScan = cub::BlockScan<int2, kThreads>;
  __shared__ union {
    typename MaxScan::TempStorage max;
    typename SumScan::TempStorage sum;
  } tmp;
  __shared__ int sh_tile, sh_first, sh_end;
  __shared__ TileState sh_prefix;
  __shared__ ulonglong2 sh_look[2 * kLookSh];
  extern __shared__ uint32_t buf[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int total = rows * tiles_per_row;
  const int cl = 1 + bstar;  // a codeword's length past its unary run
  const int cap = 32 * row_words;
  const int smem_words = tile_smem_words(bstar);
  unsigned* counter = reinterpret_cast<unsigned*>(ws);
  ulonglong2* agg_of = reinterpret_cast<ulonglong2*>(ws) + 1;
  ulonglong2* incl_of = agg_of + total;
  ulonglong2* pieces = incl_of + total;
  unsigned* published = reinterpret_cast<unsigned*>(pieces + total);  // per row
  const bool aligned = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;

  for (;;) {
    if (tid == 0) sh_tile = (int)atomicAdd(counter, 1u);
    __syncthreads();
    const int t = sh_tile;
    if (t >= total) break;
    const int row = t / tiles_per_row;
    const int j = t - row * tiles_per_row;

    // thread (w, v) owns the 32 consecutive slots from lo: thread order is
    // slot order
    const int wbase = j * kTileSlots + warp * 32 * kItems;
    const uint32_t sel = select_word(mask + (size_t)row * n, n, wbase, lane,
                                     aligned && (j + 1) * kTileSlots <= n);
    const int lo = wbase + lane * kItems;
    const int last = sel ? lo + 31 - __clz(sel) : -1;

    int prev, tile_last;  // the tile's selected slot before this thread's first
    MaxScan(tmp.max).ExclusiveScan(last, prev, -1, MaxOp(), tile_last);
    __syncthreads();
    int qsum = 0;  // q of this thread's codewords, but the tile's first
    {
      int p_prev = prev;
      uint32_t s = sel;
      while (s) {
        const int p = lo + (__ffs(s) - 1);
        s &= s - 1u;
        if (p_prev >= 0) qsum += (p - p_prev - 1) >> bstar;
        p_prev = p;
      }
    }
    int2 before, agg2;
    SumScan(tmp.sum).ExclusiveScan(make_int2(__popc(sel), qsum), before, make_int2(0, 0),
                                   SumOp(), agg2);
    if (sel && before.x == 0) sh_first = lo + (__ffs(sel) - 1);
    __syncthreads();
    const TileState agg = {agg2.x, agg2.x ? sh_first : -1, tile_last, agg2.y};

    // the tile's exclusive prefix in its row
    TileState prefix = empty_state();
    if (j == 0) {
      if (tid == 0) {
        store_state(incl_of + t, agg);
        atomicAdd(published + row, 1u);
      }
    } else {
      if (tid == 0) {
        store_state(agg_of + t, agg);
        atomicAdd(published + row, 1u);
      }
      if (warp == 0) {
        const size_t row0 = (size_t)row * tiles_per_row;
        const TileState p = look_back(agg_of + row0, incl_of + row0, published + row, j,
                                      bstar, lane, sh_look);
        if (lane == 0) {
          store_state(incl_of + t, combine(p, agg, bstar));
          sh_prefix = p;
        }
      }
      __syncthreads();
      prefix = sh_prefix;
    }

    const int r0 = prefix.c;  // rank of the tile's first codeword
    if (agg.c > 0 && r0 < k) {
      const int emitted = min(agg.c, k - r0);
      const int prev_pos = r0 ? prefix.l : -1;
      const int q_first = (agg.f - prev_pos - 1) >> bstar;
      const int s = (r0 ? (prefix.f >> bstar) + prefix.sq : 0) + r0 * cl;  // its start
      const int s2 = s + q_first;  // the end of its unary run
      const int sw = s2 >> 5;      // buf[i] is the row's word sw + i
      const long long e_full = (long long)s2 + agg.sq + (long long)agg.c * cl;
      const int zero = (int)min((long long)smem_words, ((e_full - 1) >> 5) - sw + 1);
      for (int i = tid; i < zero; i += kThreads) buf[i] = 0u;
      __syncthreads();
      const int bcap = cap - 32 * sw;
      if (tid == 0) {  // the first codeword's ones in word sw
        const int from = max(s, 32 * sw);
        or_ones(buf, bcap, from - 32 * sw, s2 - from);
      }
      int r_in = before.x;
      int qacc = before.y + (before.x > 0 ? q_first : 0);
      int p_prev = prev >= 0 ? prev : prev_pos;
      uint32_t bits = sel;
      while (bits && r_in < emitted) {
        const int p = lo + (__ffs(bits) - 1);
        bits &= bits - 1u;
        const int dm1 = p - p_prev - 1;
        const int q = dm1 >> bstar;
        const int start = s + qacc + r_in * cl;
        if (r_in > 0) or_ones(buf, bcap, start - 32 * sw, q);
        if (bstar) {
          or_field(buf, bcap, start + q + 1 - 32 * sw, (uint32_t)dm1 & ((1u << bstar) - 1u),
                   bstar);
        }
        const int end = start + q + cl;
        if (r0 + r_in == k - 1) nbits_out[row] = end;
        if (r_in == emitted - 1) sh_end = end;
        qacc += q;
        ++r_in;
        p_prev = p;
      }
      __syncthreads();

      // words wholly inside [s, e) are stored; the two partial ones are
      // the tile's pieces, which the last CTA ORs in
      const int e = sh_end;
      const int w_lo = s >> 5, w_hi = (e - 1) >> 5;
      uint32_t* out = words + (size_t)row * row_words;
      for (int w = w_lo + tid; w <= w_hi && w < row_words; w += kThreads) {
        const uint32_t val = w < sw ? 0xffffffffu >> max(s - 32 * w, 0) : buf[w - sw];
        const unsigned long long piece = (unsigned long long)(unsigned)(w + 1) << 32 | val;
        if (w == w_lo && (s & 31)) {
          pieces[t].x = piece;
        } else if (w == w_hi && (e & 31)) {
          pieces[t].y = piece;
        } else {
          out[w] = val;
        }
      }
    }
    __syncthreads();  // sh_tile, sh_end and buf are free for the next tile
    if (total <= (int)gridDim.x) break;  // one tile a CTA: the counter is spent
  }

  if (!last_cta(reinterpret_cast<unsigned*>(ws) + 1)) return;

  // thread t's first tile's pieces, loaded beside the rows' states: with
  // at most kThreads tiles the last CTA waits on memory once
  const ulonglong2 mine = tid < total ? __ldcg(pieces + tid) : make_ulonglong2(0ull, 0ull);
  // thread r: row r's end, nbits where no tile wrote it, and zeros past
  // the end (a run of stores, which no thread waits for)
  for (int row = tid; row < rows; row += kThreads) {
    int end = 0;
    if (k > 0) {
      const int written = __ldcg(nbits_out + row);
      const TileState r = tiles_per_row
          ? unpack_state(__ldcg(incl_of + (row + 1) * tiles_per_row - 1))
          : empty_state();
      if (r.c >= k) {
        end = written;
      } else {
        end = r.c ? (r.f >> bstar) + r.sq + r.c * cl : 0;
        nbits_out[row] = -1;
      }
    } else {
      nbits_out[row] = 0;
    }
    uint32_t* out = words + (size_t)row * row_words;
    for (int w = (end + 31) >> 5; w < row_words; ++w) out[w] = 0u;
  }
  // every piece's word to zero
  for (int t = tid; t < total; t += kThreads) {
    uint32_t* out = words + (size_t)(t / tiles_per_row) * row_words;
    const ulonglong2 p = t == tid ? mine : __ldcg(pieces + t);
    if (p.x) out[(p.x >> 32) - 1] = 0u;
    if (p.y) out[(p.y >> 32) - 1] = 0u;
  }
  __syncthreads();
  // OR each piece into its word, and zero the tiles' workspace
  for (int t = tid; t < total; t += kThreads) {
    uint32_t* out = words + (size_t)(t / tiles_per_row) * row_words;
    const ulonglong2 p = t == tid ? mine : __ldcg(pieces + t);
    if (p.x) atomicOr(&out[(p.x >> 32) - 1], (uint32_t)p.x);
    if (p.y) atomicOr(&out[(p.y >> 32) - 1], (uint32_t)p.y);
    agg_of[t] = incl_of[t] = pieces[t] = make_ulonglong2(0ull, 0ull);
  }
  for (int row = tid; row < rows; row += kThreads) published[row] = 0u;
  if (tid == 0) *counter = 0u;
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

extern "C" int seg_packbits_stream_launch(const void* bits, void* words, int nbits,
                                          void* stream) {
  const int nwords = (int)(((long long)nbits + 31) >> 5);
  if (nwords > 0) {
    seg_packbits_stream_kernel<<<(nwords + kStreamThreads - 1) / kStreamThreads,
                                 kStreamThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bits, (uint32_t*)words, nbits);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of seg_select_pack at this b* (its shared memory
// depends on b*), or minus the CUDA error.
extern "C" int seg_select_pack_resident(int bstar) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, seg_select_pack_kernel, kThreads, sizeof(uint32_t) * tile_smem_words(bstar));
  return err == cudaSuccess ? n : -(int)err;
}

// ws: 4 + 12 * rows * tiles_per_row + rows int32 (as kernels/pack.py
// allocates it), 16-byte aligned, zero (and left zero).  grid: G >= 1.
extern "C" int seg_select_pack_launch(const void* mask, void* words, void* nbits, void* ws,
                                      int rows, int n, int k, int bstar, int row_words,
                                      int tiles_per_row, int grid, void* stream) {
  if (rows > 0) {
    seg_select_pack_kernel<<<grid, kThreads, sizeof(uint32_t) * tile_smem_words(bstar),
                             (cudaStream_t)stream>>>(
        (const int*)mask, (uint32_t*)words, (int*)nbits, (int*)ws, rows, n, k, bstar,
        row_words, tiles_per_row);
  }
  return (int)cudaGetLastError();
}
