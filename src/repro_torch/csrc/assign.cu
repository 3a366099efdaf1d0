// Nearest-pivot assignment for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel assign_kernel
// (src/repro/kernels/assign.py:23), wrapper assign_pallas (:56,
// pallas_call at :72): PGBJ's phase-1 map.
//
// What it computes. For every row x, the pivot p minimising
//   d² = (‖x‖² + ‖p‖²) − 2·x·p, clamped at 0,
// with a strict < over pivots in index order, so the lowest index wins
// ties, and √ of that d². Output: int32 pivot id and float32 distance.
//
// Layout. One thread per row (256 rows a block), the row's coordinates in
// registers. The block stages the pivots in shared memory in chunks (all
// 256 pivots of the Forest configuration at d = 10 fit in one) with their
// norms, and every thread walks the chunk keeping a running (min d²,
// argmin). No (n, M) distance matrix ever reaches device memory.
//
// What bounds it on this card. n·M·(2·d + 3) fp32 operations against
// 4·n·(d + 2) bytes moved: at d = 10, M = 256 that is ~120 flops a byte,
// far above the ≈ 20 flops a byte at which an H100 SXM turns compute
// bound in fp32 on CUDA cores (data sheet: 67 TFLOP/s, 3.35 TB/s, at its
// 700 W limit), so it is bound by FMA throughput (each pivot coordinate is a
// shared-memory broadcast read), not by HBM.
//
// Any width. Past d = 128 a row no longer fits in registers: a second
// kernel stages the block's 256 rows and 32 pivots at a time in shared
// memory one 32-wide chunk of d at a time, each thread accumulating its
// row's dot products with the 32 pivots across the chunks (32 registers).
// Its chain is the first kernel's (‖x‖², ‖p‖² and x·p each one fmaf chain in
// ascending j, pivots compared in index order with a strict <), so both
// give the same ids and distances.
//
// This is the simple, correct first version: IEEE fp32 CUDA-core FMAs (no
// TF32), no tensor cores, no vectorised shared-memory loads. Making it
// faster is a later PR's work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ p, int* __restrict__ pid,
              float* __restrict__ dist, int n, int m, int d, int chunk) {
  extern __shared__ float smem[];
  float* s_piv = smem;                                      // chunk x d
  float* s_norm = smem + static_cast<size_t>(chunk) * d;    // chunk

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = i < n;
  float xr[MAXD];
  float xn = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    xr[j] = 0.f;
    if (active && j < d) xr[j] = x[i * d + j];
  }
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d) xn = fmaf(xr[j], xr[j], xn);
  }

  float best = CUDART_INF_F;
  int arg = -1;
  for (int p0 = 0; p0 < m; p0 += chunk) {
    const int rows = min(chunk, m - p0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < rows * d; e += kThreads)
      s_piv[e] = p[static_cast<size_t>(p0) * d + e];
    __syncthreads();
    for (int rr = threadIdx.x; rr < rows; rr += kThreads) {
      const float* pr = s_piv + rr * d;
      float pn = 0.f;
      for (int j = 0; j < d; ++j) pn = fmaf(pr[j], pr[j], pn);
      s_norm[rr] = pn;
    }
    __syncthreads();
    if (active) {
      for (int rr = 0; rr < rows; ++rr) {
        const float* pr = s_piv + rr * d;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) dot = fmaf(xr[j], pr[j], dot);
        }
        const float d2 = fmaxf((xn + s_norm[rr]) - 2.f * dot, 0.f);
        if (d2 < best) {
          best = d2;
          arg = p0 + rr;
        }
      }
    }
  }
  if (active) {
    pid[i] = arg;
    dist[i] = sqrtf(best);
  }
}

constexpr int kPT = 32;  // pivots per tile of the wide kernel
constexpr int kDC = 32;  // width of one staged chunk of d

__global__ void __launch_bounds__(kThreads)
assign_wide(const float* __restrict__ x, const float* __restrict__ p, int* __restrict__ pid,
            float* __restrict__ dist, int n, int m, int d) {
  __shared__ float x_s[kThreads][kDC + 1];
  __shared__ float p_s[kPT][kDC + 1];
  __shared__ float pn_s[kPT];
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const bool active = row0 + tid < n;
  float xn = 0.f;
  float best = CUDART_INF_F;
  int arg = -1;
  for (int p0 = 0; p0 < m; p0 += kPT) {
    const int rows = min(kPT, m - p0);
    float acc[kPT];
#pragma unroll
    for (int q = 0; q < kPT; ++q) acc[q] = 0.f;
    float pn = 0.f;
    for (int k0 = 0; k0 < d; k0 += kDC) {
      const int dk = min(kDC, d - k0);
      __syncthreads();  // the previous chunk (and the previous tile's compares) is consumed
      for (int e = tid; e < kThreads * kDC; e += kThreads) {
        const int r = e / kDC;
        const int j = e - r * kDC;
        x_s[r][j] = (row0 + r < n && j < dk) ? x[(row0 + r) * d + k0 + j] : 0.f;
      }
      for (int e = tid; e < kPT * kDC; e += kThreads) {
        const int q = e / kDC;
        const int j = e - q * kDC;
        p_s[q][j] = (q < rows && j < dk) ? p[static_cast<long long>(p0 + q) * d + k0 + j] : 0.f;
      }
      __syncthreads();
      if (p0 == 0) {
        for (int j = 0; j < dk; ++j) xn = fmaf(x_s[tid][j], x_s[tid][j], xn);
      }
      if (tid < kPT) {
        for (int j = 0; j < dk; ++j) pn = fmaf(p_s[tid][j], p_s[tid][j], pn);
      }
      for (int j = 0; j < dk; ++j) {
        const float xj = x_s[tid][j];
#pragma unroll
        for (int q = 0; q < kPT; ++q) acc[q] = fmaf(xj, p_s[q][j], acc[q]);
      }
    }
    if (tid < kPT) pn_s[tid] = pn;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPT; ++q) {
      if (q < rows) {
        const float d2 = fmaxf((xn + pn_s[q]) - 2.f * acc[q], 0.f);
        if (d2 < best) {
          best = d2;
          arg = p0 + q;
        }
      }
    }
  }
  if (active) {
    pid[row0 + tid] = arg;
    dist[row0 + tid] = sqrtf(best);
  }
}

template <int MAXD>
cudaError_t launch(const float* x, const float* p, int* pid, float* dist, int n, int m, int d,
                   cudaStream_t stream) {
  const int chunk = std::min(m, kSmemBytes / static_cast<int>(sizeof(float) * (d + 1)));
  const size_t smem = static_cast<size_t>(chunk) * (d + 1) * sizeof(float);
  const int blocks = (n + kThreads - 1) / kThreads;
  assign_kernel<MAXD><<<blocks, kThreads, smem, stream>>>(x, p, pid, dist, n, m, d, chunk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for shapes the
// kernel does not take: n, m, d >= 1). d <= 128 runs the register kernel,
// anything wider the wide one.
extern "C" int repro_assign(const void* x, const void* pivots, void* pid, void* dist, int n,
                            int m, int d, void* stream) {
  if (n < 1 || m < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* pf = static_cast<const float*>(pivots);
  auto* pi = static_cast<int*>(pid);
  auto* df = static_cast<float*>(dist);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d > 128) {
    assign_wide<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(xf, pf, pi, df, n, m, d);
    err = cudaGetLastError();
  } else if (d <= 16)
    err = launch<16>(xf, pf, pi, df, n, m, d, st);
  else if (d <= 32)
    err = launch<32>(xf, pf, pi, df, n, m, d, st);
  else if (d <= 64)
    err = launch<64>(xf, pf, pi, df, n, m, d, st);
  else
    err = launch<128>(xf, pf, pi, df, n, m, d, st);
  return static_cast<int>(err);
}
