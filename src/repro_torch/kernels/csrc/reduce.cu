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
// (kernels/reduce.py) give the same bits.
//
// Layout: x f32[rows][n] row-major; out f32[rows].  One CTA per row.
// Level 0 reads the row from device memory in passes of kChunk padded
// slots: the CTA loads a pass with coalesced loads, each thread's 32 of
// them issued before any is used, into a shared stage
// (one pad float after every window, so the 32 threads of a warp that
// then sum 32 windows hit 32 banks), and thread t sums window t of the
// pass.  The partials of levels 0 and 1 (ceil(n / 32) + ceil(n / 1024)
// floats a row) stay in shared memory when they fit beside the stage,
// else in a global scratch row the wrapper allocates; the later levels
// ping-pong between those two buffers, and one thread does the last
// <= 32 adds.
//
// What bounds it on an H100: not bytes (the exact path's rows are at most
// 2 x 12,250 floats, 98 KB, 0.03 us at 3.35 TB/s) but latency.  One CTA
// works a row, so a call of two rows runs on two SMs, and each pass of a
// row waits on a DRAM round trip and two barriers.  Summing windows
// straight from device memory, or keeping loads only a few deep, took
// about as long as issuing all of a pass's loads at once (PERF.md §6).
// Splitting a row over many CTAs, with a last CTA that finishes the
// levels, is the way to a shorter call (ROADMAP B).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;
constexpr int kChunk = kWindow * kThreads;              // padded slots a pass
constexpr int kStage = kChunk + kThreads;               // with one pad float a window
constexpr int kSmemFloats = 12288;                      // 48 KB: no opt-in needed
constexpr int kPartialFloats = kSmemFloats - kStage;    // room left for partials

__host__ __device__ __forceinline__ int windows(int n) { return (n + kWindow - 1) / kWindow; }

// Window w of a level held in memory: 32 values from 0.0f, left to right;
// padded slot j is element w * 32 + j - front, or a zero outside [0, n).
__device__ __forceinline__ float window_sum(const float* src, int n, int front, int w) {
  float v[kWindow];
  const int p0 = w * kWindow - front;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int p = p0 + j;
    v[j] = (p >= 0 && p < n) ? src[p] : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) acc = __fadd_rn(acc, v[j]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
f32_mean_xla_kernel(const float* __restrict__ x, int n0, int mean, float* scratch,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const int m0 = windows(n0);
  float* stage = smem;
  float* part = smem + kStage;
  // level 0 writes buf[0]; level l writes buf[l & 1]
  float* buf[2];
  if (scratch != nullptr) {
    buf[0] = scratch + (size_t)row * (m0 + windows(m0));
    buf[1] = buf[0] + m0;
  } else {
    buf[0] = part;
    buf[1] = part + m0;
  }
  const float* src = x + (size_t)row * n0;
  int n = n0;
  int level = 0;
  if (n > kWindow) {  // level 0, staged through shared memory
    const int front = (m0 * kWindow - n) / 2;
    float* dst = buf[0];
    for (int base = 0; base < m0 * kWindow; base += kChunk) {
      const int len = min(kChunk, m0 * kWindow - base);
      float v[kWindow];  // all of a thread's loads of the pass in flight at once
#pragma unroll
      for (int r = 0; r < kWindow; ++r) {
        const int i = r * kThreads + threadIdx.x;
        const int p = base + i - front;
        v[r] = (i < len && p >= 0 && p < n) ? src[p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kWindow; ++r) {
        const int i = r * kThreads + threadIdx.x;
        if (i < len) stage[i + i / kWindow] = v[r];
      }
      __syncthreads();
      if (threadIdx.x * kWindow < len) {
        const float* win = stage + threadIdx.x * (kWindow + 1);
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kWindow; ++j) acc = __fadd_rn(acc, win[j]);
        dst[base / kWindow + threadIdx.x] = acc;
      }
      __syncthreads();
    }
    src = dst;
    n = m0;
    level = 1;
  }
  while (n > kWindow) {
    const int m = windows(n);
    const int front = (m * kWindow - n) / 2;
    float* dst = buf[level & 1];
    for (int w = threadIdx.x; w < m; w += kThreads) dst[w] = window_sum(src, n, front, w);
    __syncthreads();
    src = dst;
    n = m;
    ++level;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, src[j]);
    out[row] = mean ? __fmul_rn(acc, __fdiv_rn(1.0f, (float)n0)) : acc;
  }
}

}  // namespace

// Floats of global scratch a row needs (0: its partials fit in shared
// memory beside the stage).  The wrapper allocates rows x this many.
extern "C" int f32_mean_xla_scratch(int n) {
  const int m0 = windows(n);
  return (n > kWindow && m0 + windows(m0) > kPartialFloats) ? m0 + windows(m0) : 0;
}

extern "C" int f32_mean_xla_launch(const void* x, int rows, int n, int mean, void* scratch,
                                   void* out, void* stream) {
  if (rows <= 0) return 0;
  const int m0 = windows(n);
  size_t smem = 0;
  if (n > kWindow) smem = sizeof(float) * (kStage + (scratch ? 0 : m0 + windows(m0)));
  f32_mean_xla_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, n, mean, (float*)scratch, (float*)out);
  return (int)cudaGetLastError();
}
