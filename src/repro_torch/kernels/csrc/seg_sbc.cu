// Segment-aware SBC passes over one block-padded flat buffer, for Hopper.
//
// Three kernels replace the three Pallas kernels of the JAX package's
// src/repro/kernels/flat.py:
//
//   seg_hist2side       <- seg_hist2side      (_seg_hist_kernel)
//   seg_moments         <- seg_moments        (_seg_moments_kernel)
//   seg_binarize_apply  <- seg_binarize_apply (_seg_apply_kernel)
//
// Layout (the flat contract of the JAX package's core/flat.py): the
// buffer is `nblocks` data blocks of `block_elems` f32 (bm * lanes =
// 8 * 128 = 1024 by default).  Every block belongs to exactly one
// segment, and block b's scalars sit in row b of a (nblocks, P) f32
// params array whose column 0 is the segment id (hist, moments).
//
// What bounds them on an H100: all three stream the buffer once and do a
// handful of operations per element (one log2 in the histogram), so they
// are bound by device-memory bytes, not by arithmetic.  The design keeps
// to one read of the buffer per pass: one CTA per data block, 256 threads
// each loading one float4 (16 bytes, neighbouring threads on neighbouring
// addresses), and per-block scalars read once per CTA.
//
// Where the TPU kernels carried a sum across the sequential grid, the
// CTAs here run in no order, so the cross-block reductions are made
// deterministic without float atomics:
//   * histogram counts are integers: shared-memory uint32 atomics per
//     CTA, then one integer atomicAdd per non-empty bin into the
//     segment's global row.  Exact and independent of CTA order.
//   * moments write per-block partials (f64 sums, uint32 counts) and a
//     second launch reduces each segment's blocks in a fixed order.
//     The sums are accumulated in f64 and rounded to f32 once, at the
//     end: every sum of a side has one sign, so the f64 result is within
//     1e-12 (relative) of the exact sum, and any other f64 summation (the
//     plain version's) rounds to the same f32 or to its neighbour.  In
//     f32, this kernel's order and another would drift apart by up to
//     (chain length) * 2^-24, about 4e-6 for LeNet5's f1.
//
// Numerics: built with -fmad=false and without --use_fast_math, so the
// bucket coordinate uses the IEEE division and the full-precision log2f
// that PyTorch's own CUDA log2 uses, and IEEE denormals are kept (no
// flush-to-zero), as in the plain PyTorch versions beside the wrappers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void hist_one(float v, float lo0, float hi0, float lglo0,
                                         float den0, float lo1, float hi1, float lglo1,
                                         float den1, float nbins_f, int nbins,
                                         unsigned* sh) {
  // side 0 bins positive entries, side 1 bins |negative| entries, each
  // over its own [lo, hi) magnitude range.
  int side;
  float lo, hi, lglo, den;
  if (v > 0.0f) {
    side = 0; lo = lo0; hi = hi0; lglo = lglo0; den = den0;
  } else if (v < 0.0f) {
    side = 1; lo = lo1; hi = hi1; lglo = lglo1; den = den1;
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
  const float lo0 = p[1], hi0 = p[2], lo1 = p[3], hi1 = p[4];
  const float lglo0 = log2f(fmaxf(lo0, 1e-38f));
  const float den0 = log2f(fmaxf(hi0, 2e-38f)) - lglo0;
  const float lglo1 = log2f(fmaxf(lo1, 1e-38f));
  const float den1 = log2f(fmaxf(hi1, 2e-38f)) - lglo1;
  const float nbins_f = (float)nbins;
  __syncthreads();

  const float4* x4 = reinterpret_cast<const float4*>(x + (size_t)b * block_elems);
  for (int i = threadIdx.x; i < block_elems / 4; i += blockDim.x) {
    const float4 v = x4[i];
    hist_one(v.x, lo0, hi0, lglo0, den0, lo1, hi1, lglo1, den1, nbins_f, nbins, sh);
    hist_one(v.y, lo0, hi0, lglo0, den0, lo1, hi1, lglo1, den1, nbins_f, nbins, sh);
    hist_one(v.z, lo0, hi0, lglo0, den0, lo1, hi1, lglo1, den1, nbins_f, nbins, sh);
    hist_one(v.w, lo0, hi0, lglo0, den0, lo1, hi1, lglo1, den1, nbins_f, nbins, sh);
  }
  __syncthreads();

  unsigned* out = hist + (size_t)seg * 2 * nbins;
  for (int i = threadIdx.x; i < 2 * nbins; i += blockDim.x) {
    const unsigned c = sh[i];
    if (c) atomicAdd(&out[i], c);
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

// Pass 1: grid = nblocks, block = kThreads.  params rows: (seg, t+, t-).
// Writes block b's f64 [sum+, sum-] to psum[b, 0:2] and [n+, n-] to pcnt[b, 0:2].
__global__ void __launch_bounds__(kThreads)
seg_moments_partial_kernel(const float* __restrict__ x, const float* __restrict__ params,
                           double* __restrict__ psum, unsigned* __restrict__ pcnt,
                           int block_elems) {
  __shared__ double ssum[2][kThreads / 32];
  __shared__ unsigned scnt[2][kThreads / 32];
  const int b = blockIdx.x;
  const float tpos = params[(size_t)b * 3 + 1];
  const float ntneg = -params[(size_t)b * 3 + 2];

  double s0 = 0.0, s1 = 0.0;
  unsigned c0 = 0u, c1 = 0u;
  const float4* x4 = reinterpret_cast<const float4*>(x + (size_t)b * block_elems);
  for (int i = threadIdx.x; i < block_elems / 4; i += blockDim.x) {
    const float4 v = x4[i];
    moment_one(v.x, tpos, ntneg, s0, c0, s1, c1);
    moment_one(v.y, tpos, ntneg, s0, c0, s1, c1);
    moment_one(v.z, tpos, ntneg, s0, c0, s1, c1);
    moment_one(v.w, tpos, ntneg, s0, c0, s1, c1);
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
    psum[(size_t)b * 2] = t0; psum[(size_t)b * 2 + 1] = t1;
    pcnt[(size_t)b * 2] = n0; pcnt[(size_t)b * 2 + 1] = n1;
  }
}

// Pass 2: grid = nseg, block = 32 (one warp per segment).  Lane l sums the
// segment's blocks l, l + 32, ... in block order; the warp then folds the
// 32 lane sums in a fixed order, in f64; the sums are rounded to f32 once.
// out: f32[nseg, 2, 2] = [[sum+, n+], [sum-, n-]].
__global__ void __launch_bounds__(32)
seg_moments_final_kernel(const double* __restrict__ psum, const unsigned* __restrict__ pcnt,
                         const float* __restrict__ params, float* __restrict__ out,
                         int nblocks) {
  const int seg = blockIdx.x;
  double s0 = 0.0, s1 = 0.0;
  unsigned c0 = 0u, c1 = 0u;
  for (int b = threadIdx.x; b < nblocks; b += 32) {
    if ((int)params[(size_t)b * 3] == seg) {
      s0 += psum[(size_t)b * 2]; s1 += psum[(size_t)b * 2 + 1];
      c0 += pcnt[(size_t)b * 2]; c1 += pcnt[(size_t)b * 2 + 1];
    }
  }
  s0 = warp_sum_d(s0);
  s1 = warp_sum_d(s1);
  c0 = warp_sum_u(c0);
  c1 = warp_sum_u(c1);
  if (threadIdx.x == 0) {
    float* o = out + (size_t)seg * 4;
    o[0] = (float)s0; o[1] = (float)c0; o[2] = (float)s1; o[3] = (float)c1;
  }
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
