// f32_mean_xla: row sums and means of f32 values in the order XLA's CPU
// backend lowers an f32 reduce, so they equal jnp.sum / jnp.mean bit for
// bit.
//
// This replaces no Pallas kernel.  The JAX package takes jnp.mean of the
// top-k values (core/stages.py topk_signed and binarize, core/flat.py
// exchange_local, kernels/ops.py sbc_compress_exact), and XLA lowers an
// f32 sum of n > 32 elements to a cascade of reduce-window passes of
// size 32, stride 32:
//
//   * pad the n values to m = ceil(n / 32) windows, with pad / 2 zeros in
//     front and the rest behind (pad = 32 m - n);
//   * sum each window left to right, starting from 0.0f;
//   * repeat on the m partials until 32 or fewer are left, then sum those
//     left to right from 0.0f;
//   * the mean is that sum times the f32 reciprocal of n (1.0f / n, IEEE
//     division), not sum / n.
//
// No single PyTorch call sums in this order, so the port writes it out.
// Every step is one f32 add (or the one multiply), built with
// -fmad=false, so the kernel and the plain PyTorch version
// (kernels/reduce.py) give the same bits whichever CTA sums which window.
//
// A sum that starts from +0.0 is never -0.0, so adding +0.0 to it changes
// nothing; and a window that lies wholly in the pad sums to +0.0.  So the
// cascade may be padded further with zeros at any level without changing
// a bit, which the design below uses: a row of m0 <= 32 windows is summed
// as one level-1 window, and a warp adds all 32 of its windows even where
// some lie past the row's ends.
//
// Layout: x f32[rows][n] row-major; out f32[rows].  The unit of work is a
// level-1 window: 32 level-0 windows, 1,024 padded slots, one warp.  The
// warp issues its 32 coalesced 128-byte loads at once (lane l of round r
// takes slot 32 r + l), transposes them through a 32 x 33 tile of its own
// in shared memory (__syncwarp, no CTA barrier), lane j sums window j,
// and the warp adds the 32 window sums in order (shuffles): the level-1
// partial.  Two routes, chosen by the wrapper (kernels/reduce.py):
//
//   * one CTA per row, when the row's level-1 windows fit in one CTA's
//     kWarps warps (n <= 4,096): the partials stay in shared memory and
//     warp 0 adds them; no scratch, no ticket.  A row of one level-1
//     window (n <= 1,024) is one warp's, and a row of one level-0 window
//     (n <= 32) one thread's: its n loads at once, then its n adds;
//   * otherwise each row is split over `cpr` CTAs of a grid that fits in
//     one wave (the wrapper sizes it from the SM count and the occupancy
//     query).  CTA c of a row takes the level-1 windows c * kWarps + w,
//     then c * kWarps + w + cpr * kWarps, ... (warp w, grid stride) and
//     writes their partials to the row's scratch.  It then fences and
//     takes the row's ticket, atomicInc(ticket, cpr - 1), which wraps to 0
//     by itself; the row's last CTA reads the partials from L2, runs the
//     upper levels there (a window per thread, ping-ponging between two
//     scratch buffers) and writes out[row].  Tickets live in the
//     self-cleaning per-(device, stream) workspace of kernels/_build.py.
//
// What bounds it on an H100: not bytes (the exact path's rows are at most
// 2 x 12,250 floats, 98 KB, 0.03 us at 3.35 TB/s) but latency: a launch,
// one DRAM round trip for the loads, one L2 round trip each for the
// ticket and for the last CTA's partials, and a few chains of 32 adds.
// The design keeps each of those to one: every warp's loads are in flight
// together, on as many SMs as the row has level-1 windows to give.
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;
constexpr int kWarps = 4;  // a CTA's warps; each sums one level-1 window at a time
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ __forceinline__ int windows(int n) { return (n + kWindow - 1) / kWindow; }

// The first two levels of a row of n values: m0 level-0 windows with f0
// pad slots in front, and m1 level-1 windows with f1 pad windows in front.
struct Levels {
  int n, m0, f0, m1, f1;
};

__host__ __device__ __forceinline__ Levels levels(int n) {
  Levels c;
  c.n = n;
  c.m0 = windows(n);
  c.f0 = (c.m0 * kWindow - n) / 2;
  c.m1 = windows(c.m0);
  c.f1 = (c.m1 * kWindow - c.m0) / 2;
  return c;
}

// By a whole warp: the sum of v over lanes 0 .. cnt - 1, left to right
// from 0.0f (cnt <= 32); every lane returns it.
__device__ __forceinline__ float ordered_sum(float v, int cnt) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    const float s = __shfl_sync(kAll, v, i);  // all issued before the adds
    if (i < cnt) acc = __fadd_rn(acc, s);
  }
  return acc;
}

// By a whole warp: level-1 window u of the row src[0 .. n), i.e. its 32
// level-0 windows 32 u - f1 .. 32 u - f1 + 31, each summed left to right,
// then added in order.  tile: the warp's own 32 x 33 floats.
__device__ __forceinline__ float level1_window(const float* __restrict__ src, const Levels& c,
                                               int u, float (*tile)[kWindow + 1]) {
  const int lane = threadIdx.x & 31;
  // element of round 0 for this lane: padded slot 32 w0 + lane, w0 the
  // unit's first level-0 window
  const long long base = (long long)kWindow * (kWindow * (long long)u - c.f1) - c.f0 + lane;
  float v[kWindow];
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    const long long e = base + kWindow * r;
    v[r] = (e >= 0 && e < c.n) ? src[e] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kWindow; ++r) tile[r][lane] = v[r];  // window r, slot lane
  __syncwarp();
  float win = 0.0f;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) win = __fadd_rn(win, tile[lane][i]);  // 32 banks
  __syncwarp();  // the tile is free for the warp's next window
  return ordered_sum(win, kWindow);
}

__device__ __forceinline__ float finish(float sum, int n, int mean) {
  return mean ? __fmul_rn(sum, __fdiv_rn(1.0f, (float)n)) : sum;
}

// Called by every thread once the CTA's partials are written: true in the
// row's last CTA, which then sees every other CTA's partials.  The ticket
// counts the row's finished CTAs and wraps to 0 by itself.
__device__ __forceinline__ bool last_of_row(unsigned* ticket, int ctas) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(ticket, (unsigned)ctas - 1u) == (unsigned)ctas - 1u;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// Window w of a level held in scratch (written in this launch: read from L2).
__device__ __forceinline__ float window_sum_l2(const float* src, int n, int front, int w) {
  float v[kWindow];
  const int p0 = w * kWindow - front;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int p = p0 + j;
    v[j] = (p >= 0 && p < n) ? __ldcg(src + p) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) acc = __fadd_rn(acc, v[j]);
  return acc;
}

// One-CTA route: grid = rows; needs levels(n).m1 <= kWarps.
__global__ void __launch_bounds__(kThreads)
f32_mean_xla_cta_kernel(const float* __restrict__ x, int n, int mean, float* __restrict__ out) {
  __shared__ float tile[kWarps][kWindow][kWindow + 1];
  __shared__ float part[kWarps];
  const Levels c = levels(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* src = x + (size_t)blockIdx.x * n;
  if (c.m0 == 1) {  // n <= 32: the cascade is its last step alone
    if (threadIdx.x == 0) {
      float v[kWindow];
#pragma unroll
      for (int j = 0; j < kWindow; ++j) v[j] = j < n ? src[j] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        if (j >= n) break;
        acc = __fadd_rn(acc, v[j]);
      }
      out[blockIdx.x] = finish(acc, n, mean);
    }
    return;
  }
  if (c.m1 == 1) {  // one level-1 window: its sum is the row's (0.0f + s == s)
    if (warp == 0) {
      const float s = level1_window(src, c, 0, tile[0]);
      if (lane == 0) out[blockIdx.x] = finish(s, n, mean);
    }
    return;
  }
  if (warp < c.m1) {
    const float s = level1_window(src, c, warp, tile[warp]);
    if (lane == 0) part[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const float s = ordered_sum(lane < c.m1 ? part[lane] : 0.0f, c.m1);
    if (lane == 0) out[blockIdx.x] = finish(s, n, mean);
  }
}

// Split route: grid = rows * cpr; CTA b works row b / cpr.  scratch:
// f32[rows][m1 + ceil(m1 / 32)]; tickets: uint32[rows], zero on entry and
// left zero.
__global__ void __launch_bounds__(kThreads)
f32_mean_xla_split_kernel(const float* __restrict__ x, int n, int mean, int cpr,
                          float* scratch, unsigned* tickets, float* __restrict__ out) {
  __shared__ float tile[kWarps][kWindow][kWindow + 1];
  const Levels c = levels(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x / cpr, cta = blockIdx.x - row * cpr;
  const float* src = x + (size_t)row * n;
  // level 1 writes odd; level l writes odd if l is odd, else even
  float* odd = scratch + (size_t)row * (c.m1 + windows(c.m1));
  float* even = odd + c.m1;
  for (int u = cta * kWarps + warp; u < c.m1; u += cpr * kWarps) {
    const float s = level1_window(src, c, u, tile[warp]);
    if (lane == 0) odd[u] = s;
  }
  if (!last_of_row(tickets + row, cpr)) return;

  const float* lvl = odd;
  int cnt = c.m1;
  for (int level = 2; cnt > kWindow; ++level) {
    const int m = windows(cnt);
    const int front = (m * kWindow - cnt) / 2;
    float* dst = (level & 1) ? odd : even;
    for (int w = threadIdx.x; w < m; w += kThreads) dst[w] = window_sum_l2(lvl, cnt, front, w);
    __syncthreads();
    lvl = dst;
    cnt = m;
  }
  if (warp == 0) {
    const float s = ordered_sum(lane < cnt ? __ldcg(lvl + lane) : 0.0f, cnt);
    if (lane == 0) out[row] = finish(s, n, mean);
  }
}

}  // namespace

// ---------------------------------------------------------------- C API

// Resident CTAs per SM of the split route (the wrapper's grid budget is
// SMs times this), or minus the CUDA error.
extern "C" int f32_mean_xla_resident(void) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, f32_mean_xla_split_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

// scratch == null: the one-CTA route (cpr must be 1 and the row's level-1
// windows at most kWarps).  Otherwise the split route over rows * cpr
// CTAs, with scratch f32[rows][m1 + ceil(m1 / 32)] and tickets
// uint32[rows] (zero, and left zero).
extern "C" int f32_mean_xla_launch(const void* x, int rows, int n, int mean, int cpr,
                                   void* scratch, void* tickets, void* out, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch == nullptr) {
    if (cpr != 1 || levels(n).m1 > kWarps) return (int)cudaErrorInvalidValue;
    f32_mean_xla_cta_kernel<<<rows, kThreads, 0, s>>>((const float*)x, n, mean, (float*)out);
  } else {
    if (cpr < 1 || tickets == nullptr) return (int)cudaErrorInvalidValue;
    f32_mean_xla_split_kernel<<<rows * cpr, kThreads, 0, s>>>(
        (const float*)x, n, mean, cpr, (float*)scratch, (unsigned*)tickets, (float*)out);
  }
  return (int)cudaGetLastError();
}
