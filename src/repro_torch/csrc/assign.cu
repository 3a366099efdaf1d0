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
// kernel does not take: n, m >= 1, 1 <= d <= 128).
extern "C" int repro_assign(const void* x, const void* pivots, void* pid, void* dist, int n,
                            int m, int d, void* stream) {
  if (n < 1 || m < 1 || d < 1 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* pf = static_cast<const float*>(pivots);
  auto* pi = static_cast<int*>(pid);
  auto* df = static_cast<float*>(dist);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 16)
    err = launch<16>(xf, pf, pi, df, n, m, d, st);
  else if (d <= 32)
    err = launch<32>(xf, pf, pi, df, n, m, d, st);
  else if (d <= 64)
    err = launch<64>(xf, pf, pi, df, n, m, d, st);
  else
    err = launch<128>(xf, pf, pi, df, n, m, d, st);
  return static_cast<int>(err);
}
