// The SBC passes for Hopper: segment-aware over one block-padded flat
// buffer, and per leaf over one unpadded tensor.
//
// Six kernels replace the six Pallas kernels of the JAX package's
// src/repro/kernels/:
//
//   seg_hist2side       <- flat.py seg_hist2side       (_seg_hist_kernel)
//   seg_moments         <- flat.py seg_moments         (_seg_moments_kernel)
//   seg_binarize_apply  <- flat.py seg_binarize_apply  (_seg_apply_kernel)
//   hist2side           <- hist2side.py hist2side      (_hist_kernel)
//   masked_moments      <- moments.py masked_moments   (_moments_kernel)
//   binarize_apply      <- binarize_apply.py binarize_apply (_apply_kernel)
//
// The per-leaf passes are the segment passes over a single segment, and
// share their code with them: the per-leaf hist2side is the same kernel
// body as seg_hist2side (hist2side_kernel, over SegBlocks or LeafBlocks),
// and masked_moments and binarize_apply share their per-element and
// per-partial code (moment_quad, partial_store, fold_warps, apply_one), so
// both give the same bits on the same values by construction.
//
// A seventh, seg_accumulate, replaces no Pallas kernel: it is the front of
// the hist exchange (the JAX package's core/flat.py exchange_local_hist and
// _hist_pipeline), which XLA fuses there and PyTorch runs as a concat, a
// residual add and an abs and an amax a segment.  In one pass it writes
// acc = R + the leaves in the block-padded layout and each segment's max
// |acc|, which the first histogram's ranges need: 12 bytes an entry (the
// leaf and R read, acc written), against 32 for the unfused ops.  It is
// bound by bytes.  The leaves' pointers change every round, so they ride in
// the launch's parameters (AccLeaves, up to kAccLeaves a launch) and no
// copy to the card waits for the stream.  A persistent grid walks the
// blocks as the histogram does, every thread with the loads of kAccAhead
// blocks in flight; each thread keeps its segment's running max of |acc|'s
// bits (a max of uint32 bits is the float max on non-negative values, and
// puts a NaN above +inf as torch.amax does), a warp folds it with one
// shuffle reduction and adds it with one atomicMax at a change of segment,
// and the last CTA writes the result and zeroes its words.  The max is
// exact in any order, and acc is the same IEEE addition as R + flat.
//
// Segment layout (the flat contract of the JAX package's core/flat.py):
// the buffer is `nblocks` data blocks of `block_elems` f32 (bm * lanes =
// 8 * 128 = 1024 by default).  Every block belongs to exactly one
// segment, and block b's scalars sit in row b of a (nblocks, P) f32
// params array whose column 0 is the segment id (hist, moments).
//
// Leaf layout: any f32 tensor x[0 .. n), n >= 1, unpadded; the tail is
// guarded inside the kernels, and a start that is not 16-byte aligned (a
// view at an odd offset) takes scalar loads.  Scalars (ranges,
// thresholds, mu, side) are read from device memory, so nothing waits
// for the host.
//
// What bounds them on an H100: all stream the data once (5 MB for LeNet5,
// 1.5 us at 3.35 TB/s).  The binarize passes do a few operations per
// element and are bound by bytes.  The histogram does an IEEE division
// and a full-precision log2f per counted element, tens of instructions,
// so its coarse pass (nearly every element counted) is bound by that
// arithmetic and by how many warps an SM holds to cover its latency, not
// by bytes.  At this size a pass is over before latency is hidden, so
// beyond the bytes and the arithmetic a call costs its device operations
// and the waits that no other work covers.
//
// seg_hist2side, the per-leaf hist2side and seg_moments are one launch
// each, on a persistent grid of G CTAs that fits in one wave (G = SMs x
// the CTAs an SM holds at once, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, at most nblocks; the
// wrapper passes it).  CTA c walks the contiguous blocks [c*nblocks/G,
// (c+1)*nblocks/G), so it meets few segments.
//
//   * seg_hist2side loads a block's float4 and params row and bins them,
//     one block at a time: loads of more blocks in flight would cost
//     registers, and so resident warps, that the coarse pass's arithmetic
//     needs more.  A block whose ranges repeat the previous block's keeps
//     its log2 terms (4 log2f per block, besides one per element).  The
//     per-leaf hist2side runs the same body over its leaf in blocks of
//     kThreads quads (1,024 entries, the tail guarded; scalar loads where
//     the leaf is not 16-byte aligned): one segment, one range pair per
//     side, so its log2 terms are computed once, before the walk.  Its
//     grid gives a CTA about two blocks (the wrapper's leaf_grid_blocks;
//     more where the card holds fewer CTAs), since a CTA's zeroing, flush
//     and ticket cost the same whatever it walks, and it loads the next
//     block's quad before it bins the current one.  A warp does the division and the log2 of a
//     slot (v.x, v.y, ...) if any of its lanes counts an entry there, so
//     where the counted entries of a warp are few (the zoomed pass) they
//     are packed into fewer rounds first (hist_quad_warp).  A CTA adds its
//     shared counts into a
//     uint32 workspace, one global atomicAdd per non-empty counter, when
//     its segment changes and once at its end; the leaf's counters have a
//     128-byte line each (LeafBlocks::kStride), since every CTA adds to
//     the same few hot bins and a line's atomics queue at its L2 slice.
//     The last CTA converts the workspace to the f32 result and zeroes it:
//     no memset before the kernel and no int->f32 copy after it.
//   * seg_moments loads the first quads and thresholds of kMomentsAhead
//     blocks at once, and writes each block's partial (f64 sums, uint32
//     counts).  The last CTA finds each segment's first and last block in
//     one pass over params column 0 (shared atomicMin / atomicMax at the
//     changes of segment id), stages up to kFoldChunk partials at a time
//     in shared memory, every thread with its kBatch loads in flight, and
//     its 8 warps fold 8 segments at a time, each lane loading kChainStep
//     steps of its chain before adding them.
//   * masked_moments is one launch too (masked_moments_kernel), but not on
//     seg_moments' persistent grid: that design, a CTA a block, took 9 us
//     on 1.26 M values, and the per-leaf pass's two launches 7 us.  A warp
//     sums a whole partial of 1,024 entries, its 8 quads a lane all loaded
//     before the first add, with shuffles only; at larger spans a warp
//     takes fewer of the partial's 8 groups, so their chains run side by
//     side, and the partial's ticket adds the group sums in order.  The
//     last CTA folds the partials with seg_moments' fold.
//
// The last CTA is found with a ticket: after a barrier, thread 0 fences
// the CTA's writes and takes atomicInc(ticket, G - 1); the CTA that draws
// G - 1 is last, and the ticket has wrapped to 0 for the next launch.  The
// workspace (tickets, counts) is allocated zeroed once per
// (device, stream) by the wrapper and every launch leaves the words it
// used zero, so nothing clears it between calls.
//
// Results do not depend on which CTA runs when: histogram counts are sums
// of integers, exact in any order; the moment sums are f64 additions in an order fixed by the data's layout
// alone: a block's partial is summed by one CTA in thread and warp order,
// and the fold adds a segment's partials in index order (counted from the
// segment's first partial b0, lane L of one warp takes b0 + L, b0 + L +
// 32, ... in order, then the warp folds the 32 lane sums with warp_sum_d),
// after every partial is written.  The sums are rounded to f32 once, at
// the end.  Every sum of a side has one sign, so the f64 result is within
// 1e-12 (relative) of the exact sum.  The plain versions in
// kernels/flat.py repeat this order step by step.
//
// Numerics: built with -fmad=false and without --use_fast_math, so the
// bucket coordinate uses the IEEE division and the full-precision log2f
// that PyTorch's own CUDA log2 uses, and IEEE denormals are kept (no
// flush-to-zero), as in the plain PyTorch versions beside the wrappers.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLeafElemsPerCta = 8192;  // per-leaf binarize
constexpr int kLeafMaxCtas = 2048;
constexpr int kMomentsAhead = 4;        // blocks whose loads a moments CTA issues at once
constexpr int kBatch = 5;               // loads a thread of the last CTA issues at once
constexpr int kFoldChunk = kThreads * kBatch;  // partials the fold stages at once: 1,280,
                                        // LeNet5's 1,230 blocks in one
constexpr int kChainStep = 4;           // steps of a lane's fold loaded at once
constexpr int kAccLeaves = 224;         // leaves one seg_accumulate launch carries
constexpr int kAccAhead = 4;            // blocks whose loads an accumulate thread issues at once

// The two sides' magnitude ranges and their log2 terms.
struct HistRanges {
  float lo0, hi0, lglo0, den0, lo1, hi1, lglo1, den1;
};

__device__ __forceinline__ HistRanges make_ranges(float lo0, float hi0, float lo1,
                                                  float hi1) {
  HistRanges r;
  r.lo0 = lo0; r.hi0 = hi0; r.lo1 = lo1; r.hi1 = hi1;
  r.lglo0 = log2f(fmaxf(lo0, 1e-38f));
  r.den0 = log2f(fmaxf(hi0, 2e-38f)) - r.lglo0;
  r.lglo1 = log2f(fmaxf(lo1, 1e-38f));
  r.den1 = log2f(fmaxf(hi1, 2e-38f)) - r.lglo1;
  return r;
}

__device__ __forceinline__ void hist_one(float v, const HistRanges& r, float nbins_f,
                                         int nbins, unsigned* sh) {
  // side 0 bins positive entries, side 1 bins |negative| entries, each
  // over its own [lo, hi) magnitude range.
  int side;
  float lo, hi, lglo, den;
  if (v > 0.0f) {
    side = 0; lo = r.lo0; hi = r.hi0; lglo = r.lglo0; den = r.den0;
  } else if (v < 0.0f) {
    side = 1; lo = r.lo1; hi = r.hi1; lglo = r.lglo1; den = r.den1;
  } else {
    return;
  }
  const float a = fabsf(v);
  if (!(a >= lo && a < hi)) return;
  const float f = (log2f(fmaxf(a, 1e-38f)) - lglo) / den;
  int bucket = __float2int_rz(f * nbins_f);
  bucket = bucket < 0 ? 0 : (bucket > nbins - 1 ? nbins - 1 : bucket);
  atomicAdd(&sh[side * nbins + bucket], 1u);
}

// Whether hist_one counts an entry (its first two tests alone).
__device__ __forceinline__ bool hist_counts(float v, const HistRanges& r) {
  const float a = fabsf(v);
  return v > 0.0f ? (a >= r.lo0 && a < r.hi0) : (v < 0.0f && a >= r.lo1 && a < r.hi1);
}

__device__ __forceinline__ void hist_quad(float4 v, const HistRanges& r, float nbins_f,
                                          int nbins, unsigned* sh) {
  hist_one(v.x, r, nbins_f, nbins, sh);
  hist_one(v.y, r, nbins_f, nbins, sh);
  hist_one(v.z, r, nbins_f, nbins, sh);
  hist_one(v.w, r, nbins_f, nbins, sh);
}

// hist_quad by a whole warp (all 32 lanes call it).  A warp pays for the
// log2 and the division of a slot (v.x, v.y, ...) when any of its lanes
// counts an entry there, so when the warp's counted entries fit in fewer
// rounds of 32 than the slots they occupy (the zoomed pass, where few
// entries are in range), they are first packed into the warp's 128 floats
// of `buf` and each lane takes every 32nd.
__device__ __forceinline__ void hist_quad_warp(float4 v, const HistRanges& r,
                                               float nbins_f, int nbins, unsigned* sh,
                                               float* buf) {
  const bool i0 = hist_counts(v.x, r), i1 = hist_counts(v.y, r);
  const bool i2 = hist_counts(v.z, r), i3 = hist_counts(v.w, r);
  const unsigned m0 = __ballot_sync(0xffffffffu, i0), m1 = __ballot_sync(0xffffffffu, i1);
  const unsigned m2 = __ballot_sync(0xffffffffu, i2), m3 = __ballot_sync(0xffffffffu, i3);
  const int n0 = __popc(m0), n01 = n0 + __popc(m1), n012 = n01 + __popc(m2);
  const int n = n012 + __popc(m3);
  const int slots = (m0 != 0u) + (m1 != 0u) + (m2 != 0u) + (m3 != 0u);
  if ((n + 31) / 32 >= slots) {  // uniform over the warp
    hist_quad(v, r, nbins_f, nbins, sh);
    return;
  }
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (i0) buf[__popc(m0 & below)] = v.x;
  if (i1) buf[n0 + __popc(m1 & below)] = v.y;
  if (i2) buf[n01 + __popc(m2 & below)] = v.z;
  if (i3) buf[n012 + __popc(m3 & below)] = v.w;
  __syncwarp();
  for (int i = lane; i < n; i += 32) hist_one(buf[i], r, nbins_f, nbins, sh);
  __syncwarp();
}

// Counter i of a histogram in the workspace is word i * stride of it.
__device__ __forceinline__ void hist_flush(const unsigned* sh, unsigned* out, int nbins,
                                           int stride) {
  for (int i = threadIdx.x; i < 2 * nbins; i += blockDim.x) {
    const unsigned c = sh[i];
    if (c) atomicAdd(&out[i * stride], c);
  }
}

size_t hist_smem(int nbins) { return 2 * (size_t)nbins * sizeof(unsigned); }

// Called by every thread once the CTA's writes are issued: true in the CTA
// that finishes last, after which that CTA sees every other CTA's writes.
// The ticket counts finished CTAs and wraps to 0 by itself.  As in a grid
// barrier of cooperative groups, the CTA's barrier orders its threads'
// writes before thread 0's fence and ticket, and the last CTA's thread 0
// fences again before the barrier that releases its other threads.
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

// The contiguous blocks [lo, hi) that CTA blockIdx.x of a persistent grid walks.
__device__ __forceinline__ void cta_blocks(int nblocks, int& lo, int& hi) {
  lo = (int)((long long)blockIdx.x * nblocks / gridDim.x);
  hi = (int)((long long)(blockIdx.x + 1) * nblocks / gridDim.x);
}

// The segment layout as the histogram walks it: block b is the quads
// [b * quads, (b + 1) * quads) of x (quads = block_elems / 4), and its
// segment id and ranges are params row b: (seg, lo+, hi+, lo-, hi-).
struct SegBlocks {
  static constexpr bool kLeaf = false;
  static constexpr int kStride = 1;  // workspace words a counter
  const float4* x4;
  const float* params;
  int nblocks, quads;
  __device__ __forceinline__ float4 quad(int b, int q) const {
    return x4[(size_t)b * quads + q];
  }
};

// One unpadded leaf x[0 .. n) as the histogram walks it: blocks of
// kThreads quads, the tail guarded (zeros are never counted), one segment
// and one range pair per side, [lo[s * lo_step], hi[s * hi_step]) for
// side s (a step of 0 gives both sides one scalar).  kVec: x is 16-byte
// aligned, so a whole quad is one float4 load; else four scalar loads.
// Each counter has a 128-byte line of the workspace to itself (kStride):
// the coarse pass's counts crowd into a few bins, and every CTA's atomics
// on the few lines that hold them queue at those lines' L2 slices.
template <bool kVec>
struct LeafBlocks {
  static constexpr bool kLeaf = true;
  static constexpr int kStride = 32;
  static constexpr int quads = kThreads;
  const float* x;
  int n, nblocks;
  const float* lo;
  int lo_step;
  const float* hi;
  int hi_step;
  __device__ __forceinline__ float4 quad(int b, int q) const {
    const int e = (b * kThreads + q) * 4;
    if (kVec && e + 3 < n) return reinterpret_cast<const float4*>(x)[e / 4];
    return make_float4(e < n ? x[e] : 0.0f, e + 1 < n ? x[e + 1] : 0.0f,
                       e + 2 < n ? x[e + 2] : 0.0f, e + 3 < n ? x[e + 3] : 0.0f);
  }
};

constexpr int kLeafBlockElems = 4 * kThreads;  // a leaf block: one quad a thread

int leaf_blocks(int n) { return (n + kLeafBlockElems - 1) / kLeafBlockElems; }

// The histogram of seg_hist2side (Blocks = SegBlocks) and of the per-leaf
// hist2side (LeafBlocks): grid = G <= nblocks (G >= 1), block = kThreads,
// dynamic smem = hist_smem(nbins).  work: uint32[nseg, 2, nbins,
// Blocks::kStride] and *ticket, zero on entry and left zero.  out:
// f32[nseg, 2, nbins], written whole by the last CTA (a leaf: nseg = 1).
template <class Blocks>
__global__ void __launch_bounds__(kThreads)
hist2side_kernel(Blocks src, unsigned* __restrict__ work, unsigned* __restrict__ ticket,
                 float* __restrict__ out, int nbins, int nseg) {
  extern __shared__ unsigned sh[];
  __shared__ float packed[kWarps][128];
  float* buf = packed[threadIdx.x >> 5];
  for (int i = threadIdx.x; i < 2 * nbins; i += kThreads) sh[i] = 0u;
  int b_lo, b_hi;
  cta_blocks(src.nblocks, b_lo, b_hi);
  const bool mine = threadIdx.x < src.quads;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float nbins_f = (float)nbins;

  int cur = -1;
  HistRanges r;
  bool have = false;
  float rl0 = 0.0f, rh0 = 0.0f, rl1 = 0.0f, rh1 = 0.0f;
  float4 next = zero4;  // a leaf's next block's quad, in flight while it bins this one
  if constexpr (Blocks::kLeaf) {  // one segment and one range pair: log2 terms once
    r = make_ranges(src.lo[0], src.hi[0], src.lo[src.lo_step], src.hi[src.hi_step]);
    cur = 0;
    if (b_lo < b_hi) next = src.quad(b_lo, threadIdx.x);
    __syncthreads();  // the shared counts are zero
  }
  for (int b = b_lo; b < b_hi; ++b) {
    float4 v;
    if constexpr (Blocks::kLeaf) {
      v = next;
      if (b + 1 < b_hi) next = src.quad(b + 1, threadIdx.x);
    } else {
      v = mine ? src.quad(b, threadIdx.x) : zero4;
      const float* p = src.params + (size_t)b * 5;
      const int seg = (int)p[0];
      const float l0 = p[1], h0 = p[2], l1 = p[3], h1 = p[4];
      if (seg != cur) {  // uniform: every thread reads the same row
        __syncthreads();
        if (cur >= 0) {
          hist_flush(sh, work + (size_t)cur * 2 * nbins * Blocks::kStride, nbins,
                     Blocks::kStride);
          for (int i = threadIdx.x; i < 2 * nbins; i += kThreads) sh[i] = 0u;
        }
        cur = seg;
        __syncthreads();
      }
      // a block whose ranges repeat the previous block's keeps its log2 terms
      if (!(have && l0 == rl0 && h0 == rh0 && l1 == rl1 && h1 == rh1)) {
        r = make_ranges(l0, h0, l1, h1);
        rl0 = l0; rh0 = h0; rl1 = l1; rh1 = h1;
        have = true;
      }
    }
    hist_quad_warp(v, r, nbins_f, nbins, sh, buf);  // zeros are not counted
    for (int q0 = kThreads; q0 < src.quads; q0 += kThreads) {
      const int q = q0 + threadIdx.x;
      hist_quad_warp(q < src.quads ? src.quad(b, q) : zero4, r, nbins_f, nbins, sh, buf);
    }
  }
  __syncthreads();
  if (cur >= 0) hist_flush(sh, work + (size_t)cur * 2 * nbins * Blocks::kStride, nbins,
                          Blocks::kStride);

  if (!last_cta(ticket)) return;
  const int words = nseg * 2 * nbins;
  for (int i0 = 0; i0 < words; i0 += kThreads * kBatch) {
    unsigned c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(i0 + u * kThreads + (int)threadIdx.x, words - 1);
      c[u] = __ldcg(work + (size_t)i * Blocks::kStride);  // other CTAs' atomics: from L2
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      if (i < words) {
        out[i] = (float)c[u];
        work[(size_t)i * Blocks::kStride] = 0u;
      }
    }
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void moment_one(float v, float tpos, float ntneg, double& s0,
                                           unsigned& c0, double& s1, unsigned& c1) {
  if (v >= tpos) { s0 += (double)v; c0 += 1u; }
  if (v <= ntneg) { s1 += (double)v; c1 += 1u; }
}

__device__ __forceinline__ void moment_quad(float4 v, float tpos, float ntneg, double& s0,
                                            unsigned& c0, double& s1, unsigned& c1) {
  moment_one(v.x, tpos, ntneg, s0, c0, s1, c1);
  moment_one(v.y, tpos, ntneg, s0, c0, s1, c1);
  moment_one(v.z, tpos, ntneg, s0, c0, s1, c1);
  moment_one(v.w, tpos, ntneg, s0, c0, s1, c1);
}

// One partial from its threads' sums: the warps fold their 32 threads with
// warp_sum_d, and thread 0 adds the kWarps warp sums in order and writes
// f64 [sum+, sum-] to psum[0:2] and [n+, n-] to pcnt[0:2].  ssum / scnt
// are this partial's shared slots; the caller does not write them again
// before every thread has passed another __syncthreads.
__device__ __forceinline__ void partial_store(double s0, unsigned c0, double s1, unsigned c1,
                                              double (*ssum)[kWarps],
                                              unsigned (*scnt)[kWarps],
                                              double* __restrict__ psum,
                                              unsigned* __restrict__ pcnt) {
  s0 = warp_sum_d(s0);
  s1 = warp_sum_d(s1);
  c0 = warp_sum_u(c0);
  c1 = warp_sum_u(c1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ssum[0][warp] = s0; ssum[1][warp] = s1;
    scnt[0][warp] = c0; scnt[1][warp] = c1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t0 = 0.0, t1 = 0.0;
    unsigned n0 = 0u, n1 = 0u;
    for (int w = 0; w < kWarps; ++w) {
      t0 += ssum[0][w]; t1 += ssum[1][w];
      n0 += scnt[0][w]; n1 += scnt[1][w];
    }
    psum[0] = t0; psum[1] = t1;
    pcnt[0] = n0; pcnt[1] = n1;
  }
}

// One partial's sums, by one CTA of kThreads: the entries xb[0 .. count).
// Thread t takes the quads (4 entries) t, t + kThreads, ... in order, each
// quad's entries in order, then partial_store.  vec: xb is 16-byte
// aligned, so a whole quad is one float4 load.
__device__ __forceinline__ void moments_partial(const float* __restrict__ xb, int count,
                                                bool vec, float tpos, float ntneg,
                                                double* __restrict__ psum,
                                                unsigned* __restrict__ pcnt) {
  __shared__ double ssum[2][kWarps];
  __shared__ unsigned scnt[2][kWarps];
  double s0 = 0.0, s1 = 0.0;
  unsigned c0 = 0u, c1 = 0u;
  const int quads = (count + 3) / 4;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int e = 4 * q;
    if (vec && e + 3 < count) {
      moment_quad(reinterpret_cast<const float4*>(xb)[q], tpos, ntneg, s0, c0, s1, c1);
    } else {
      for (int c = 0; c < 4 && e + c < count; ++c)
        moment_one(xb[e + c], tpos, ntneg, s0, c0, s1, c1);
    }
  }
  partial_store(s0, c0, s1, c1, ssum, scnt, psum, pcnt);
}

// The fold's shared staging: the sums, counts and segment ids of up to
// kFoldChunk consecutive partials.
struct FoldStage {
  double2 sum[kFoldChunk];
  uint2 cnt[kFoldChunk];
  int seg[kFoldChunk];
};

// Fold, by the whole CTA of kThreads, one segment per warp: warp w adds the
// partials of segment `seg` in [b0, b_last] (b0 > b_last: none; seg_of(b)
// gives partial b's segment) in a fixed order: lane L adds the partials
// b0 + L, b0 + L + 32, ... in index order; the warp then folds the 32 lane
// sums with warp_sum_d, and lane 0 writes f32 [[sum+, n+], [sum-, n-]] to
// out[0:4] (out: null for a warp without a segment).  The partials of the
// warps' ranges pass through `st` kFoldChunk at a time, each thread
// issuing its kBatch loads at once; each lane adds its partials from
// shared memory, in order.
template <class SegOf>
__device__ void fold_warps(const double* __restrict__ psum,
                           const unsigned* __restrict__ pcnt, SegOf seg_of_b, int seg,
                           int b0, int b_last, float* __restrict__ out, FoldStage& st) {
  __shared__ int lo_w[kWarps], hi_w[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    lo_w[warp] = b0;
    hi_w[warp] = b_last;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int w = 0; w < kWarps; ++w) {
    if (lo_w[w] <= hi_w[w]) {
      lo = min(lo, lo_w[w]);
      hi = max(hi, hi_w[w]);
    }
  }
  double s0 = 0.0, s1 = 0.0;
  unsigned c0 = 0u, c1 = 0u;
  __syncthreads();  // lo_w and hi_w read by every thread
  for (int c = lo; c <= hi; c += kFoldChunk) {
    const int n = min(kFoldChunk, hi + 1 - c);
    double2 ls[kBatch];
    uint2 lc[kBatch];
    int lg[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = c + min(u * kThreads + (int)threadIdx.x, n - 1);
      ls[u] = __ldcg(reinterpret_cast<const double2*>(psum) + b);  // other CTAs': L2
      lc[u] = __ldcg(reinterpret_cast<const uint2*>(pcnt) + b);
      lg[u] = seg_of_b(b);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = u * kThreads + threadIdx.x;
      if (k < n) {
        st.sum[k] = ls[u];
        st.cnt[k] = lc[u];
        st.seg[k] = lg[u];
      }
    }
    __syncthreads();
    int b = b0 + lane;  // this lane's first partial at or after c
    if (b < c) b += (c - b + 31) / 32 * 32;
    const int end = min(c + n - 1, b_last);
    const int steps = b <= end ? (end - b) / 32 + 1 : 0;
    // kChainStep steps at a time: their operands are loaded first, then
    // added in order.  A step past the end, or on a partial of another
    // segment, adds +0.0 and 0: the same bits as skipping it, since no lane
    // sum is ever -0.0 (each side's sums have one sign).
    for (int j0 = 0; j0 < steps; j0 += kChainStep) {
      double2 ps[kChainStep];
      uint2 pc[kChainStep];
      bool m[kChainStep];
#pragma unroll
      for (int u = 0; u < kChainStep; ++u) {
        const int k = min(b + 32 * (j0 + u), end) - c;
        ps[u] = st.sum[k];
        pc[u] = st.cnt[k];
        m[u] = j0 + u < steps && st.seg[k] == seg;
      }
#pragma unroll
      for (int u = 0; u < kChainStep; ++u) {
        s0 += m[u] ? ps[u].x : 0.0; s1 += m[u] ? ps[u].y : 0.0;
        c0 += m[u] ? pc[u].x : 0u; c1 += m[u] ? pc[u].y : 0u;
      }
    }
    __syncthreads();  // every lane is done with st
  }
  s0 = warp_sum_d(s0);
  s1 = warp_sum_d(s1);
  c0 = warp_sum_u(c0);
  c1 = warp_sum_u(c1);
  if (lane == 0 && out != nullptr) {
    out[0] = (float)s0; out[1] = (float)c0; out[2] = (float)s1; out[3] = (float)c1;
  }
}

__device__ __forceinline__ int seg_of(const float* params, int b) {
  return (int)params[(size_t)b * 3];
}

struct SegOfBlock {
  const float* params;
  __device__ int operator()(int b) const { return seg_of(params, b); }
};

// grid = G <= nblocks (G >= 1), block = kThreads.  params rows: (seg, t+,
// t-).  Writes block b's f64 [sum+, sum-] to psum[b, 0:2] and [n+, n-] to
// pcnt[b, 0:2]; the last CTA folds them into out: f32[nseg, 2, 2] =
// [[sum+, n+], [sum-, n-]].  *ticket is zero on entry and left zero.
__global__ void __launch_bounds__(kThreads)
seg_moments_kernel(const float* __restrict__ x, const float* __restrict__ params,
                   double* __restrict__ psum, unsigned* __restrict__ pcnt,
                   unsigned* __restrict__ ticket, float* __restrict__ out, int nblocks,
                   int block_elems, int nseg) {
  __shared__ double ssum[2][2][kWarps];  // by block parity
  __shared__ unsigned scnt[2][2][kWarps];
  __shared__ int first_b[kThreads], last_b[kThreads];
  __shared__ FoldStage st;
  int b_lo, b_hi;
  cta_blocks(nblocks, b_lo, b_hi);
  const int quads = block_elems / 4;
  const bool mine = threadIdx.x < quads;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // block b's partial: thread t takes the quads t, t + kThreads, ... in
  // order (moments_partial's order); the first quads and thresholds of
  // kMomentsAhead blocks are loaded at once
  for (int b0 = b_lo; b0 < b_hi; b0 += kMomentsAhead) {
    float4 v[kMomentsAhead];
    float tpos[kMomentsAhead], ntneg[kMomentsAhead];
#pragma unroll
    for (int u = 0; u < kMomentsAhead; ++u) {
      const int b = min(b0 + u, b_hi - 1);
      v[u] = mine ? x4[(size_t)b * quads + threadIdx.x] : zero4;
      tpos[u] = params[(size_t)b * 3 + 1];
      ntneg[u] = -params[(size_t)b * 3 + 2];
    }
#pragma unroll
    for (int u = 0; u < kMomentsAhead; ++u) {
      const int b = b0 + u;
      if (b >= b_hi) break;
      double s0 = 0.0, s1 = 0.0;
      unsigned c0 = 0u, c1 = 0u;
      if (mine) moment_quad(v[u], tpos[u], ntneg[u], s0, c0, s1, c1);
      for (int q = threadIdx.x + kThreads; q < quads; q += kThreads)
        moment_quad(x4[(size_t)b * quads + q], tpos[u], ntneg[u], s0, c0, s1, c1);
      partial_store(s0, c0, s1, c1, ssum[b & 1], scnt[b & 1], psum + (size_t)b * 2,
                    pcnt + (size_t)b * 2);
    }
  }

  if (!last_cta(ticket)) return;
  const int warp = threadIdx.x >> 5;
  for (int g0 = 0; g0 < nseg; g0 += kThreads) {  // segments g0 .. g0 + ns - 1
    const int ns = min(kThreads, nseg - g0);
    if (threadIdx.x < ns) {
      first_b[threadIdx.x] = nblocks;
      last_b[threadIdx.x] = -1;
    }
    __syncthreads();
    // their first and last blocks: only a block at a change of segment id
    // touches the shared slots
    for (int bb = 0; bb < nblocks; bb += kThreads * kBatch) {
      int sg[kBatch], before[kBatch], after[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = min(bb + u * kThreads + (int)threadIdx.x, nblocks - 1);
        sg[u] = seg_of(params, b);
        before[u] = b > 0 ? seg_of(params, b - 1) : -1;
        after[u] = b + 1 < nblocks ? seg_of(params, b + 1) : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = bb + u * kThreads + threadIdx.x, i = sg[u] - g0;
        if (b >= nblocks || i < 0 || i >= ns) continue;
        if (before[u] != sg[u]) atomicMin(&first_b[i], b);
        if (after[u] != sg[u]) atomicMax(&last_b[i], b);
      }
    }
    __syncthreads();
    for (int i0 = 0; i0 < ns; i0 += kWarps) {  // kWarps segments at once
      const int w = i0 + warp;
      if (w < ns) {
        fold_warps(psum, pcnt, SegOfBlock{params}, g0 + w, first_b[w], last_b[w],
                   out + (size_t)(g0 + w) * 4, st);
      } else {
        fold_warps(psum, pcnt, SegOfBlock{params}, -1, nblocks, -1, nullptr, st);
      }
    }
  }
}

struct OneSegment {
  __device__ int operator()(int) const { return 0; }
};

// Warps of the contract's CTA of kThreads threads: a partial's "groups".
constexpr int kGroups = kWarps;

// One entry of a quad as moment_one adds it, or nothing when it lies past
// the partial (e >= count): its quads are the contract's, whatever loads.
__device__ __forceinline__ void moment_quad_n(float4 v, int valid, float tpos, float ntneg,
                                              double& s0, unsigned& c0, double& s1,
                                              unsigned& c1) {
  if (valid >= 4) {
    moment_quad(v, tpos, ntneg, s0, c0, s1, c1);
    return;
  }
  if (valid > 0) moment_one(v.x, tpos, ntneg, s0, c0, s1, c1);
  if (valid > 1) moment_one(v.y, tpos, ntneg, s0, c0, s1, c1);
  if (valid > 2) moment_one(v.z, tpos, ntneg, s0, c0, s1, c1);
}

// masked_moments, one launch: grid = any G >= 1, block = kThreads, one
// warp per "unit".  The sums are the two-kernel contract's (moments_partial
// then the fold) bit for bit: partial p covers x[p * span, min(n, (p + 1) *
// span)), "thread" t = 32 g + l of group g takes the partial's quads t,
// t + kThreads, ... in order, each group is folded by warp_sum_d and the
// kGroups group sums are added in order; then the partials' fold.
//
// A unit is kGpw groups of one partial (kGpw in {8, 4, 2, 1}: the wrapper
// takes the most with kGpw * steps <= 8, steps = the quads a contract
// thread takes): lane l carries the contract's threads 32 g + l of its
// groups, each with its own f64 sums, and issues its loads kLoads at a time
// (at bm * lanes = 1,024: the 8 coalesced quads of one partial, all in
// flight before the first add).  Units are dealt warp-major over the grid
// (unit = warp * G + blockIdx.x), so a few units (large spans) still spread
// over SMs.  The group folds are shuffles; no shared memory and no barrier
// until the end.
//
// A whole partial (kGpw = 8): lane 0 adds the group sums and writes psum[p],
// pcnt[p].  A split partial: lane 0 writes its groups' sums to gsum[p, g]
// and its counts to gcnt[unit], fences, and takes the partial's ticket
// (pticket[p], atomicInc wrapping to 0); the unit that draws the last adds
// the partial's kGroups group sums in order.  Then the last CTA (ticket)
// stages every partial and warp 0 folds them (fold_warps, as seg_moments'
// fold).  kVec: x is 16-byte aligned and span % 4 == 0, so every whole
// quad is one float4 load; else four scalar loads.
template <int kGpw, bool kVec>
__global__ void __launch_bounds__(kThreads)
masked_moments_kernel(const float* __restrict__ x, int n, int span, int nparts, int steps,
                      const float* __restrict__ t_pos, const float* __restrict__ t_neg,
                      double2* __restrict__ psum, uint2* __restrict__ pcnt,
                      double2* __restrict__ gsum, uint2* __restrict__ gcnt,
                      unsigned* __restrict__ pticket, unsigned* __restrict__ ticket,
                      float* __restrict__ out) {
  constexpr int kSplit = kGroups / kGpw;          // units a partial
  constexpr int kLoads = kGpw == 1 ? 16 : 8;      // loads a lane issues at once
  constexpr int kStepsAt = kLoads / kGpw;         // steps they cover
  __shared__ FoldStage st;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp * gridDim.x + blockIdx.x;
  if (unit < nparts * kSplit) {
    const float tpos = *t_pos, ntneg = -*t_neg;
    const int p = unit / kSplit, g0 = (unit % kSplit) * kGpw;
    const float* xb = x + (size_t)p * span;
    const int count = min(span, n - p * span);
    double s0[kGpw], s1[kGpw];
    unsigned c0 = 0u, c1 = 0u;
#pragma unroll
    for (int g = 0; g < kGpw; ++g) s0[g] = s1[g] = 0.0;
    for (int r0 = 0; r0 < steps; r0 += kStepsAt) {
      float4 v[kLoads];
      int valid[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {  // load step r0 + j / kGpw of group g0 + j % kGpw
        const int r = r0 + j / kGpw;
        const int e = 4 * (r * kThreads + (g0 + j % kGpw) * 32 + lane);
        valid[j] = r < steps ? min(4, max(0, count - e)) : 0;
        if (kVec && valid[j] == 4) {
          v[j] = reinterpret_cast<const float4*>(xb)[e / 4];
        } else {
          v[j] = make_float4(valid[j] > 0 ? xb[e] : 0.0f, valid[j] > 1 ? xb[e + 1] : 0.0f,
                             valid[j] > 2 ? xb[e + 2] : 0.0f, valid[j] > 3 ? xb[e + 3] : 0.0f);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        moment_quad_n(v[j], valid[j], tpos, ntneg, s0[j % kGpw], c0, s1[j % kGpw], c1);
    }
#pragma unroll
    for (int g = 0; g < kGpw; ++g) {
      s0[g] = warp_sum_d(s0[g]);
      s1[g] = warp_sum_d(s1[g]);
    }
    c0 = warp_sum_u(c0);
    c1 = warp_sum_u(c1);
    if (lane == 0) {
      if (kSplit == 1) {
        double t0 = 0.0, t1 = 0.0;
#pragma unroll
        for (int g = 0; g < kGpw; ++g) { t0 += s0[g]; t1 += s1[g]; }
        psum[p] = make_double2(t0, t1);
        pcnt[p] = make_uint2(c0, c1);
      } else {
#pragma unroll
        for (int g = 0; g < kGpw; ++g) gsum[(size_t)p * kGroups + g0 + g] = make_double2(s0[g], s1[g]);
        gcnt[unit] = make_uint2(c0, c1);
        __threadfence();
        if (atomicInc(&pticket[p], kSplit - 1) == kSplit - 1) {
          __threadfence();
          double t0 = 0.0, t1 = 0.0;
          unsigned n0 = 0u, n1 = 0u;
          for (int g = 0; g < kGroups; ++g) {
            const double2 gs = __ldcg(gsum + (size_t)p * kGroups + g);  // other warps': L2
            t0 += gs.x; t1 += gs.y;
          }
          for (int u = 0; u < kSplit; ++u) {
            const uint2 gc = __ldcg(gcnt + (size_t)p * kSplit + u);
            n0 += gc.x; n1 += gc.y;
          }
          psum[p] = make_double2(t0, t1);
          pcnt[p] = make_uint2(n0, n1);
        }
      }
    }
  }
  if (!last_cta(ticket)) return;
  const bool folds = warp == 0;
  fold_warps(reinterpret_cast<const double*>(psum), reinterpret_cast<const unsigned*>(pcnt),
             OneSegment{}, 0, folds ? 0 : nparts, folds ? nparts - 1 : -1,
             folds ? out : nullptr, st);
}

__device__ __forceinline__ void apply_one(float v, float tpos, float ntneg, float mu,
                                          bool pos_wins, float& o, float& r) {
  const bool m = pos_wins ? (v >= tpos) : (v <= ntneg);
  o = m ? mu : 0.0f;
  r = v - o;
}

// grid = nblocks, block = kThreads.  params rows: (t+, t-, mu, pos_wins).
// out = mask ? mu : 0 and res = x - out, one read and two writes.
__global__ void __launch_bounds__(kThreads)
seg_binarize_apply_kernel(const float* __restrict__ x, const float* __restrict__ params,
                          float* __restrict__ out, float* __restrict__ res,
                          int block_elems) {
  const int b = blockIdx.x;
  const float* p = params + (size_t)b * 4;
  const float tpos = p[0], ntneg = -p[1], mu = p[2];
  const bool pos_wins = p[3] > 0.5f;
  const size_t base = (size_t)b * block_elems / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x) + base;
  float4* o4 = reinterpret_cast<float4*>(out) + base;
  float4* r4 = reinterpret_cast<float4*>(res) + base;
  for (int i = threadIdx.x; i < block_elems / 4; i += blockDim.x) {
    const float4 v = x4[i];
    float4 o, r;
    apply_one(v.x, tpos, ntneg, mu, pos_wins, o.x, r.x);
    apply_one(v.y, tpos, ntneg, mu, pos_wins, o.y, r.y);
    apply_one(v.z, tpos, ntneg, mu, pos_wins, o.z, r.z);
    apply_one(v.w, tpos, ntneg, mu, pos_wins, o.w, r.w);
    o4[i] = o;
    r4[i] = r;
  }
}

// grid <= kLeafMaxCtas, block = kThreads.  t_pos, t_neg, mu, pos_wins: f32
// scalars in device memory.  kVec: x is 16-byte aligned (out and res, fresh
// allocations, always are), so the body moves float4s and the tail scalars.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
binarize_apply_kernel(const float* __restrict__ x, int n, const float* __restrict__ t_pos,
                      const float* __restrict__ t_neg, const float* __restrict__ mu_p,
                      const float* __restrict__ side_p, float* __restrict__ out,
                      float* __restrict__ res) {
  const float tpos = *t_pos, ntneg = -*t_neg, mu = *mu_p;
  const bool pos_wins = *side_p > 0.5f;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int head = 0;
  if (kVec) {
    head = n / 4 * 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    float4* r4 = reinterpret_cast<float4*>(res);
    for (int i = tid; i < n / 4; i += stride) {
      const float4 v = x4[i];
      float4 o, r;
      apply_one(v.x, tpos, ntneg, mu, pos_wins, o.x, r.x);
      apply_one(v.y, tpos, ntneg, mu, pos_wins, o.y, r.y);
      apply_one(v.z, tpos, ntneg, mu, pos_wins, o.z, r.z);
      apply_one(v.w, tpos, ntneg, mu, pos_wins, o.w, r.w);
      o4[i] = o;
      r4[i] = r;
    }
  }
  for (int i = head + tid; i < n; i += stride)
    apply_one(x[i], tpos, ntneg, mu, pos_wins, out[i], res[i]);
}

// ------------------------------------------------------------ accumulate

// The leaves of one seg_accumulate launch, by value in its parameters
// (3,600 of the 4,096 bytes a launch takes), so that nothing is copied to
// the card before it: leaf j is ptr[j][0 .. size[j]) and fills the flat
// entries [off[j], off[j] + size[j]); its pad runs to off[j + 1], and
// off[n] ends the launch's blocks.  seg0 is the segment id of leaf 0.
struct AccLeaves {
  const float* ptr[kAccLeaves];
  int off[kAccLeaves + 1];
  int size[kAccLeaves];
  int n, seg0;
};

// Entries i .. i + 3 of a leaf of n entries, 0 past its end: one float4
// where the leaf is 16-byte aligned and holds all four (i is a multiple of
// 4), else scalar loads.
__device__ __forceinline__ float4 leaf_quad(const float* p, int i, int n) {
  if (i + 3 < n && (reinterpret_cast<uintptr_t>(p) & 15u) == 0u)
    return *reinterpret_cast<const float4*>(p + i);
  return make_float4(i < n ? p[i] : 0.0f, i + 1 < n ? p[i + 1] : 0.0f,
                     i + 2 < n ? p[i + 2] : 0.0f, i + 3 < n ? p[i + 3] : 0.0f);
}

// acc = r + x (x is 0 in the pad); inside the leaf, |acc|'s bits into m.
// The bits of a non-negative float order as the float does, and a NaN's
// lie above +inf's.
__device__ __forceinline__ float acc_one(float x, float r, bool has_res, bool in_leaf,
                                         unsigned& m) {
  const float a = has_res ? r + x : x;
  if (in_leaf) m = max(m, __float_as_uint(a) & 0x7fffffffu);
  return a;
}

// A segment's running max, folded over the warp; lane 0 adds it to the
// segment's workspace word (a max, whose identity is the zero it starts at).
__device__ __forceinline__ void acc_flush(unsigned m, unsigned* word) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(word, m);
}

// grid = G <= the launch's blocks (G >= 1), block = kThreads.  acc =
// res + the leaves in the block-padded layout (res + 0 in the pads; the
// leaves alone, pads 0, without res), and absmax[seg0 + j] = max |acc| over
// leaf j's entries.  work[seg0 .. seg0 + n) and *ticket are zero on entry
// and left zero.
__global__ void __launch_bounds__(kThreads)
seg_accumulate_kernel(const __grid_constant__ AccLeaves L, const float* __restrict__ res,
                      float* __restrict__ acc, unsigned* __restrict__ work,
                      unsigned* __restrict__ ticket, float* __restrict__ absmax,
                      int block_elems) {
  const int quads = block_elems / 4;
  const int b_first = L.off[0] / block_elems;
  int b_lo, b_hi;
  cta_blocks(L.off[L.n] / block_elems - b_first, b_lo, b_hi);
  const bool has_res = res != nullptr;
  const float4* r4 = reinterpret_cast<const float4*>(res);
  float4* a4 = reinterpret_cast<float4*>(acc);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int j = 0, cur = -1;  // the leaf of the last block looked up; the leaf m holds
  unsigned m = 0u;
  for (int b0 = b_lo; b0 < b_hi; b0 += kAccAhead) {
    int lf[kAccAhead];
#pragma unroll
    for (int u = 0; u < kAccAhead; ++u) {  // uniform: the same blocks in every thread
      const long long e0 = (long long)(b_first + b0 + u) * block_elems;
      if (b0 + u < b_hi)
        while (e0 >= L.off[j + 1]) ++j;
      lf[u] = j;
    }
    for (int q0 = 0; q0 < quads; q0 += kThreads) {
      const int q = q0 + threadIdx.x;
      float4 x[kAccAhead], r[kAccAhead];
      long long e[kAccAhead];
      int i[kAccAhead];
#pragma unroll
      for (int u = 0; u < kAccAhead; ++u) {  // every load in flight before the first add
        const bool live = b0 + u < b_hi && q < quads;
        e[u] = (long long)(b_first + b0 + u) * block_elems + 4 * q;
        i[u] = (int)(e[u] - L.off[lf[u]]);
        x[u] = live ? leaf_quad(L.ptr[lf[u]], i[u], L.size[lf[u]]) : zero4;
        r[u] = live && has_res ? r4[e[u] / 4] : zero4;
      }
#pragma unroll
      for (int u = 0; u < kAccAhead; ++u) {
        if (b0 + u >= b_hi) break;
        if (lf[u] != cur) {  // uniform
          if (cur >= 0) acc_flush(m, &work[L.seg0 + cur]);
          cur = lf[u];
          m = 0u;
        }
        if (q < quads) {
          const int n = L.size[cur];
          float4 a;
          a.x = acc_one(x[u].x, r[u].x, has_res, i[u] < n, m);
          a.y = acc_one(x[u].y, r[u].y, has_res, i[u] + 1 < n, m);
          a.z = acc_one(x[u].z, r[u].z, has_res, i[u] + 2 < n, m);
          a.w = acc_one(x[u].w, r[u].w, has_res, i[u] + 3 < n, m);
          a4[e[u] / 4] = a;
        }
      }
    }
  }
  if (cur >= 0) acc_flush(m, &work[L.seg0 + cur]);

  if (!last_cta(ticket)) return;
  for (int s = threadIdx.x; s < L.n; s += kThreads) {
    unsigned* word = &work[L.seg0 + s];
    absmax[L.seg0 + s] = __uint_as_float(__ldcg(word));  // other CTAs' atomics: from L2
    *word = 0u;
  }
}

int leaf_ctas(int n) {
  const int ctas = (n + kLeafElemsPerCta - 1) / kLeafElemsPerCta;
  return ctas < 1 ? 1 : (ctas > kLeafMaxCtas ? kLeafMaxCtas : ctas);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

// CTAs of `kernel` that one SM of the current device holds at once, or
// minus the CUDA error.
template <class Kernel>
int resident(Kernel kernel, size_t smem) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// ---------------------------------------------------------------- C API
// Plain C entry points for ctypes.  Each launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (0 = cudaSuccess) so a refused launch is reported to the wrapper.

// Resident CTAs per SM of the persistent-grid kernels (the wrapper's G is
// SMs times this, at most nblocks).
extern "C" int seg_hist2side_resident(int nbins) {
  return resident(hist2side_kernel<SegBlocks>, hist_smem(nbins));
}

// Resident CTAs per SM of the per-leaf histogram (its G is SMs times this,
// at most leaf_blocks(n)).
extern "C" int hist2side_resident(int nbins) {
  return resident(hist2side_kernel<LeafBlocks<true>>, hist_smem(nbins));
}

extern "C" int seg_moments_resident(void) { return resident(seg_moments_kernel, 0); }

extern "C" int seg_accumulate_resident(void) { return resident(seg_accumulate_kernel, 0); }

// leaves: n (1 <= n <= kAccLeaves) pointers to the f32 leaves; offs: n + 1
// ints, leaf j filling [offs[j], offs[j] + sizes[j]) with its pad up to
// offs[j + 1], every offs[j] a multiple of block_elems (itself of 4).  seg0:
// the segment id of leaf 0 (its word of work, its entry of absmax).  res:
// f32 covering the blocks, 16-byte aligned, or null; acc: f32, 16-byte
// aligned.  work: uint32 words seg0 .. seg0 + n - 1 and ticket: one uint32,
// zero (and left zero).  grid: G >= 1, at most the launch's blocks.
extern "C" int seg_accumulate_launch(const void* leaves, const void* offs, const void* sizes,
                                     int n, int seg0, const void* res, void* acc, void* work,
                                     void* ticket, void* absmax, int block_elems, int grid,
                                     void* stream) {
  if (n < 1 || n > kAccLeaves) return (int)cudaErrorInvalidValue;
  AccLeaves L;
  const float* const* p = (const float* const*)leaves;
  const int *o = (const int*)offs, *z = (const int*)sizes;
  for (int j = 0; j < n; ++j) {
    L.ptr[j] = p[j];
    L.off[j] = o[j];
    L.size[j] = z[j];
  }
  L.off[n] = o[n];
  L.n = n;
  L.seg0 = seg0;
  seg_accumulate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      L, (const float*)res, (float*)acc, (unsigned*)work, (unsigned*)ticket, (float*)absmax,
      block_elems);
  return (int)cudaGetLastError();
}

// work: uint32[nseg * 2 * nbins] and ticket: one uint32, both zero (and
// left zero).  grid: G >= 1.
extern "C" int seg_hist2side_launch(const void* x, const void* params, void* work,
                                    void* ticket, void* out, int nblocks, int block_elems,
                                    int nbins, int nseg, int grid, void* stream) {
  const SegBlocks src{(const float4*)x, (const float*)params, nblocks, block_elems / 4};
  hist2side_kernel<SegBlocks><<<grid, kThreads, hist_smem(nbins), (cudaStream_t)stream>>>(
      src, (unsigned*)work, (unsigned*)ticket, (float*)out, nbins, nseg);
  return (int)cudaGetLastError();
}

// psum: f64[nblocks, 2] and pcnt: uint32[nblocks, 2] scratch, written
// whole; ticket: one uint32, zero (and left zero).  grid: G >= 1.
extern "C" int seg_moments_launch(const void* x, const void* params, void* psum,
                                  void* pcnt, void* ticket, void* out, int nblocks,
                                  int block_elems, int nseg, int grid, void* stream) {
  seg_moments_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)params, (double*)psum, (unsigned*)pcnt,
      (unsigned*)ticket, (float*)out, nblocks, block_elems, nseg);
  return (int)cudaGetLastError();
}

extern "C" int seg_binarize_apply_launch(const void* x, const void* params, void* out,
                                         void* res, int nblocks, int block_elems,
                                         void* stream) {
  if (nblocks > 0) {
    seg_binarize_apply_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)params, (float*)out, (float*)res, block_elems);
  }
  return (int)cudaGetLastError();
}

// work: uint32[2 * nbins * 32] (a line a counter) and ticket: one uint32,
// both zero (and left zero).  grid: G >= 1, at most leaf_blocks(n).
extern "C" int hist2side_launch(const void* x, int n, const void* lo, int lo_step,
                                const void* hi, int hi_step, void* work, void* ticket,
                                void* out, int nbins, int grid, void* stream) {
  const size_t smem = hist_smem(nbins);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *lof = (const float*)lo, *hif = (const float*)hi;
  if (aligned16(x)) {
    const LeafBlocks<true> src{xf, n, leaf_blocks(n), lof, lo_step, hif, hi_step};
    hist2side_kernel<LeafBlocks<true>><<<grid, kThreads, smem, s>>>(
        src, (unsigned*)work, (unsigned*)ticket, (float*)out, nbins, 1);
  } else {
    const LeafBlocks<false> src{xf, n, leaf_blocks(n), lof, lo_step, hif, hi_step};
    hist2side_kernel<LeafBlocks<false>><<<grid, kThreads, smem, s>>>(
        src, (unsigned*)work, (unsigned*)ticket, (float*)out, nbins, 1);
  }
  return (int)cudaGetLastError();
}

// Groups a unit of masked_moments_kernel carries at this span (see there).
extern "C" int masked_moments_gpw(int span) {
  const int steps = (span + kLeafBlockElems - 1) / kLeafBlockElems;
  int gpw = kGroups;
  while (gpw > 1 && gpw * steps > kGroups) gpw /= 2;
  return gpw;
}

// scratch: f64 words, written whole before they are read: psum double2[nparts],
// then (split partials) gsum double2[nparts * 8], then pcnt uint2[nparts] and
// (split) gcnt uint2[nparts * 8 / gpw]: the double2s first, 16-byte aligned.  work: the ticket, then (split) nparts tickets, all
// zero (and left zero).  grid: G >= 1.
extern "C" int masked_moments_launch(const void* x, int n, int span, const void* t_pos,
                                     const void* t_neg, void* scratch, void* work,
                                     void* out, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nparts = (int)(((long long)n + span - 1) / span);
  const int steps = (span + kLeafBlockElems - 1) / kLeafBlockElems;
  const int gpw = masked_moments_gpw(span);
  const bool vec = aligned16(x) && span % 4 == 0;
  double* sc = (double*)scratch;
  const size_t gwords = gpw < kGroups ? 2 * (size_t)nparts * kGroups : 0;
  double2* psum = (double2*)sc;
  double2* gsum = (double2*)(sc + 2 * (size_t)nparts);
  uint2* pcnt = (uint2*)(sc + 2 * (size_t)nparts + gwords);
  uint2* gcnt = (uint2*)(sc + 3 * (size_t)nparts + gwords);
  unsigned* ticket = (unsigned*)work;
  unsigned* pticket = ticket + 1;
  const float* xf = (const float*)x;
  const float *tp = (const float*)t_pos, *tn = (const float*)t_neg;
  float* o = (float*)out;
#define MM_LAUNCH(G, V)                                                                   \
  masked_moments_kernel<G, V><<<grid, kThreads, 0, s>>>(xf, n, span, nparts, steps, tp, tn, \
                                                         psum, pcnt, gsum, gcnt, pticket,  \
                                                         ticket, o)
  switch (gpw * 2 + (vec ? 1 : 0)) {
    case 17: MM_LAUNCH(8, true); break;
    case 16: MM_LAUNCH(8, false); break;
    case 9: MM_LAUNCH(4, true); break;
    case 8: MM_LAUNCH(4, false); break;
    case 5: MM_LAUNCH(2, true); break;
    case 4: MM_LAUNCH(2, false); break;
    case 3: MM_LAUNCH(1, true); break;
    default: MM_LAUNCH(1, false); break;
  }
#undef MM_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int binarize_apply_launch(const void* x, int n, const void* t_pos,
                                     const void* t_neg, const void* mu,
                                     const void* pos_wins, void* out, void* res,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(x)) {
    binarize_apply_kernel<true><<<leaf_ctas(n), kThreads, 0, s>>>(
        (const float*)x, n, (const float*)t_pos, (const float*)t_neg, (const float*)mu,
        (const float*)pos_wins, (float*)out, (float*)res);
  } else {
    binarize_apply_kernel<false><<<leaf_ctas(n), kThreads, 0, s>>>(
        (const float*)x, n, (const float*)t_pos, (const float*)t_neg, (const float*)mu,
        (const float*)pos_wins, (float*)out, (float*)res);
  }
  return (int)cudaGetLastError();
}
