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
// share their per-element and per-partial code with them (hist_one,
// moments_partial, fold_partials), so both give the same bits on the same
// values by construction.
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
// What bounds them on an H100: all stream the data once and do a handful
// of operations per element (one log2 in the histogram), so they are
// bound by device-memory bytes, not by arithmetic.  The design keeps to
// one read of the data per pass: 256 threads a CTA, each loading float4s
// (16 bytes, neighbouring threads on neighbouring addresses).
//
// Where the TPU kernels carried a sum across the sequential grid, the
// CTAs here run in no order, so the cross-CTA reductions are made
// deterministic without float atomics:
//   * histogram counts are integers: shared-memory uint32 atomics per
//     CTA, then one integer atomicAdd per non-empty bin into the global
//     row.  Exact and independent of CTA order.
//   * moments write per-partial sums (f64 sums, uint32 counts; a partial
//     is one data block, or bm * lanes consecutive entries of a leaf) and
//     a second launch folds each segment's partials in a fixed order:
//     counted from the segment's first partial, lane l of one warp takes
//     the partials l, l + 32, ... in order, then the warp folds the 32
//     lane sums.  The sums are rounded to f32 once, at the end.  Every sum of a side has one sign, so the
//     f64 result is within 1e-12 (relative) of the exact sum.  The plain
//     versions in kernels/flat.py repeat this order step by step.
//
// Numerics: built with -fmad=false and without --use_fast_math, so the
// bucket coordinate uses the IEEE division and the full-precision log2f
// that PyTorch's own CUDA log2 uses, and IEEE denormals are kept (no
// flush-to-zero), as in the plain PyTorch versions beside the wrappers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeafElemsPerCta = 8192;  // per-leaf histogram and binarize
constexpr int kLeafMaxCtas = 2048;

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

__device__ __forceinline__ void hist_flush(const unsigned* sh, unsigned* out, int nbins) {
  for (int i = threadIdx.x; i < 2 * nbins; i += blockDim.x) {
    const unsigned c = sh[i];
    if (c) atomicAdd(&out[i], c);
  }
}

// grid = nblocks, block = kThreads, dynamic smem = 2 * nbins * 4 bytes.
// params rows: (seg, lo+, hi+, lo-, hi-).  hist: uint32[nseg, 2, nbins],
// zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
seg_hist2side_kernel(const float* __restrict__ x, const float* __restrict__ params,
                     unsigned* __restrict__ hist, int block_elems, int nbins) {
  extern __shared__ unsigned sh[];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * nbins; i += blockDim.x) sh[i] = 0u;

  const float* p = params + (size_t)b * 5;
  const int seg = (int)p[0];
  const HistRanges r = make_ranges(p[1], p[2], p[3], p[4]);
  const float nbins_f = (float)nbins;
  __syncthreads();

  const float4* x4 = reinterpret_cast<const float4*>(x + (size_t)b * block_elems);
  for (int i = threadIdx.x; i < block_elems / 4; i += blockDim.x) {
    const float4 v = x4[i];
    hist_one(v.x, r, nbins_f, nbins, sh);
    hist_one(v.y, r, nbins_f, nbins, sh);
    hist_one(v.z, r, nbins_f, nbins, sh);
    hist_one(v.w, r, nbins_f, nbins, sh);
  }
  __syncthreads();
  hist_flush(sh, hist + (size_t)seg * 2 * nbins, nbins);
}

// grid <= kLeafMaxCtas, block = kThreads, dynamic smem = 2 * nbins * 4
// bytes.  Side s's range is [lo[s * lo_step], hi[s * hi_step]): a step of
// 0 gives both sides one scalar.  hist: uint32[2, nbins], zeroed by the
// caller.  kVec: x is 16-byte aligned (float4 body, scalar tail).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist2side_kernel(const float* __restrict__ x, int n, const float* __restrict__ lo,
                 int lo_step, const float* __restrict__ hi, int hi_step,
                 unsigned* __restrict__ hist, int nbins) {
  extern __shared__ unsigned sh[];
  for (int i = threadIdx.x; i < 2 * nbins; i += blockDim.x) sh[i] = 0u;
  const HistRanges r = make_ranges(lo[0], hi[0], lo[lo_step], hi[hi_step]);
  const float nbins_f = (float)nbins;
  __syncthreads();

  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int head = 0;
  if (kVec) {
    head = n / 4 * 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = tid; i < n / 4; i += stride) {
      const float4 v = x4[i];
      hist_one(v.x, r, nbins_f, nbins, sh);
      hist_one(v.y, r, nbins_f, nbins, sh);
      hist_one(v.z, r, nbins_f, nbins, sh);
      hist_one(v.w, r, nbins_f, nbins, sh);
    }
  }
  for (int i = head + tid; i < n; i += stride) hist_one(x[i], r, nbins_f, nbins, sh);
  __syncthreads();
  hist_flush(sh, hist, nbins);
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

// One partial's sums, by one CTA of kThreads: the entries xb[0 .. count).
// Thread t takes the quads (4 entries) t, t + kThreads, ... in order, each
// quad's entries in order; the warps fold their 32 threads with
// warp_sum_d, and thread 0 adds the 8 warp sums in order and writes f64
// [sum+, sum-] to psum[0:2] and [n+, n-] to pcnt[0:2].  vec: xb is
// 16-byte aligned, so a whole quad is one float4 load.
__device__ __forceinline__ void moments_partial(const float* __restrict__ xb, int count,
                                                bool vec, float tpos, float ntneg,
                                                double* __restrict__ psum,
                                                unsigned* __restrict__ pcnt) {
  __shared__ double ssum[2][kThreads / 32];
  __shared__ unsigned scnt[2][kThreads / 32];
  double s0 = 0.0, s1 = 0.0;
  unsigned c0 = 0u, c1 = 0u;
  const int quads = (count + 3) / 4;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int e = 4 * q;
    if (vec && e + 3 < count) {
      const float4 v = reinterpret_cast<const float4*>(xb)[q];
      moment_one(v.x, tpos, ntneg, s0, c0, s1, c1);
      moment_one(v.y, tpos, ntneg, s0, c0, s1, c1);
      moment_one(v.z, tpos, ntneg, s0, c0, s1, c1);
      moment_one(v.w, tpos, ntneg, s0, c0, s1, c1);
    } else {
      for (int c = 0; c < 4 && e + c < count; ++c)
        moment_one(xb[e + c], tpos, ntneg, s0, c0, s1, c1);
    }
  }
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
    for (int w = 0; w < kThreads / 32; ++w) {
      t0 += ssum[0][w]; t1 += ssum[1][w];
      n0 += scnt[0][w]; n1 += scnt[1][w];
    }
    psum[0] = t0; psum[1] = t1;
    pcnt[0] = n0; pcnt[1] = n1;
  }
}

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Fold one segment's partials, by one warp, in a fixed order: counted
// from the segment's first partial b0 (the least b that member()
// accepts), lane L adds the segment's partials b0 + L, b0 + L + 32, ... in
// index order; the warp then folds the 32 lane sums with warp_sum_d.
// Lane 0 writes f32 [[sum+, n+], [sum-, n-]] to out[0:4].
//
// The walk itself is in absolute order: lane l adds the partials
// b = l (mod 32), which are the partials of lane (l - b0) mod 32 in the
// order above, with the same additions.  So each lane walks its partials
// without waiting on any other lane, and one shuffle by b0 at the end
// hands every sum to its lane.
template <class Member>
__device__ __forceinline__ void fold_partials(const double* __restrict__ psum,
                                              const unsigned* __restrict__ pcnt,
                                              int nparts, Member member,
                                              float* __restrict__ out) {
  const int lane = threadIdx.x;
  double s0 = 0.0, s1 = 0.0;
  unsigned c0 = 0u, c1 = 0u;
  int first = nparts;
  for (int b = lane; b < nparts; b += 32) {
    if (member(b)) {
      first = min(first, b);
      s0 += psum[(size_t)b * 2]; s1 += psum[(size_t)b * 2 + 1];
      c0 += pcnt[(size_t)b * 2]; c1 += pcnt[(size_t)b * 2 + 1];
    }
  }
  const int src = (lane + warp_min_i(first)) & 31;
  s0 = __shfl_sync(0xffffffffu, s0, src);
  s1 = __shfl_sync(0xffffffffu, s1, src);
  c0 = __shfl_sync(0xffffffffu, c0, src);
  c1 = __shfl_sync(0xffffffffu, c1, src);
  s0 = warp_sum_d(s0);
  s1 = warp_sum_d(s1);
  c0 = warp_sum_u(c0);
  c1 = warp_sum_u(c1);
  if (lane == 0) {
    out[0] = (float)s0; out[1] = (float)c0; out[2] = (float)s1; out[3] = (float)c1;
  }
}

// Pass 1: grid = nblocks, block = kThreads.  params rows: (seg, t+, t-).
// Writes block b's f64 [sum+, sum-] to psum[b, 0:2] and [n+, n-] to pcnt[b, 0:2].
__global__ void __launch_bounds__(kThreads)
seg_moments_partial_kernel(const float* __restrict__ x, const float* __restrict__ params,
                           double* __restrict__ psum, unsigned* __restrict__ pcnt,
                           int block_elems) {
  const int b = blockIdx.x;
  moments_partial(x + (size_t)b * block_elems, block_elems, true,
                  params[(size_t)b * 3 + 1], -params[(size_t)b * 3 + 2],
                  psum + (size_t)b * 2, pcnt + (size_t)b * 2);
}

struct InSegment {
  const float* params;
  int seg;
  __device__ bool operator()(int b) const { return (int)params[(size_t)b * 3] == seg; }
};

// Pass 2: grid = nseg, block = 32 (one warp per segment).
// out: f32[nseg, 2, 2] = [[sum+, n+], [sum-, n-]].
__global__ void __launch_bounds__(32)
seg_moments_final_kernel(const double* __restrict__ psum, const unsigned* __restrict__ pcnt,
                         const float* __restrict__ params, float* __restrict__ out,
                         int nblocks) {
  fold_partials(psum, pcnt, nblocks, InSegment{params, (int)blockIdx.x},
                out + (size_t)blockIdx.x * 4);
}

// Per-leaf pass 1: grid = nparts, block = kThreads; partial p covers
// x[p * span, min(n, (p + 1) * span)).
__global__ void __launch_bounds__(kThreads)
masked_moments_partial_kernel(const float* __restrict__ x, int n, int span,
                              const float* __restrict__ t_pos,
                              const float* __restrict__ t_neg,
                              double* __restrict__ psum, unsigned* __restrict__ pcnt) {
  const int p = blockIdx.x;
  const size_t start = (size_t)p * span;
  const float* xb = x + start;
  const size_t rest = (size_t)n - start;
  const int count = rest < (size_t)span ? (int)rest : span;
  const bool vec = (reinterpret_cast<uintptr_t>(xb) & 15u) == 0u;
  moments_partial(xb, count, vec, *t_pos, -*t_neg, psum + (size_t)p * 2,
                  pcnt + (size_t)p * 2);
}

struct EveryPartial {
  __device__ bool operator()(int) const { return true; }
};

// Per-leaf pass 2: grid = 1, block = 32.  out: f32[2, 2].
__global__ void __launch_bounds__(32)
masked_moments_final_kernel(const double* __restrict__ psum,
                            const unsigned* __restrict__ pcnt, int nparts,
                            float* __restrict__ out) {
  fold_partials(psum, pcnt, nparts, EveryPartial{}, out);
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

int leaf_ctas(int n) {
  const int ctas = (n + kLeafElemsPerCta - 1) / kLeafElemsPerCta;
  return ctas < 1 ? 1 : (ctas > kLeafMaxCtas ? kLeafMaxCtas : ctas);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// ---------------------------------------------------------------- C API
// Plain C entry points for ctypes.  Each launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// (0 = cudaSuccess) so a refused launch is reported to the wrapper.

extern "C" int seg_hist2side_launch(const void* x, const void* params, void* hist,
                                    int nblocks, int block_elems, int nbins,
                                    void* stream) {
  if (nblocks > 0) {
    seg_hist2side_kernel<<<nblocks, kThreads, 2 * nbins * sizeof(unsigned),
                           (cudaStream_t)stream>>>(
        (const float*)x, (const float*)params, (unsigned*)hist, block_elems, nbins);
  }
  return (int)cudaGetLastError();
}

extern "C" int seg_moments_launch(const void* x, const void* params, void* psum,
                                  void* pcnt, void* out, int nblocks, int block_elems,
                                  int nseg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nblocks > 0) {
    seg_moments_partial_kernel<<<nblocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)params, (double*)psum, (unsigned*)pcnt,
        block_elems);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (nseg > 0) {
    seg_moments_final_kernel<<<nseg, 32, 0, s>>>(
        (const double*)psum, (const unsigned*)pcnt, (const float*)params, (float*)out,
        nblocks);
  }
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

extern "C" int hist2side_launch(const void* x, int n, const void* lo, int lo_step,
                                const void* hi, int hi_step, void* hist, int nbins,
                                void* stream) {
  const size_t smem = 2 * nbins * sizeof(unsigned);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(x)) {
    hist2side_kernel<true><<<leaf_ctas(n), kThreads, smem, s>>>(
        (const float*)x, n, (const float*)lo, lo_step, (const float*)hi, hi_step,
        (unsigned*)hist, nbins);
  } else {
    hist2side_kernel<false><<<leaf_ctas(n), kThreads, smem, s>>>(
        (const float*)x, n, (const float*)lo, lo_step, (const float*)hi, hi_step,
        (unsigned*)hist, nbins);
  }
  return (int)cudaGetLastError();
}

extern "C" int masked_moments_launch(const void* x, int n, int span, const void* t_pos,
                                     const void* t_neg, void* psum, void* pcnt, void* out,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nparts = (int)(((long long)n + span - 1) / span);
  masked_moments_partial_kernel<<<nparts, kThreads, 0, s>>>(
      (const float*)x, n, span, (const float*)t_pos, (const float*)t_neg, (double*)psum,
      (unsigned*)pcnt);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  masked_moments_final_kernel<<<1, 32, 0, s>>>(
      (const double*)psum, (const unsigned*)pcnt, nparts, (float*)out);
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
