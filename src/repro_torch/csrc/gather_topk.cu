// Scheduled gather top-k for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
// distance_topk_gather_alive_kernel (src/repro/kernels/distance_topk.py:189)
// and distance_topk_gather_kernel (:154), wrapper
// distance_topk_gather_pallas (:224, pallas_call at :293): one kernel with
// an optional alive pointer.
//
// What it computes. For every query row of R tile i, the KP smallest
//   d² = (‖r‖² + ‖s‖²) − 2·r·s, clamped at 0,
// over the rows s of the S tiles that schedule[i, 0:counts[i]] names. Rows
// at or past n_s and rows with alive ≤ 0 never enter; slots at or past
// counts[i] are dead (compaction pads them by repeating the last entry).
// Ties in d² go to the lower packed position. It writes √d² of the first k
// entries and their int32 positions; an empty slot is (+inf, -1).
//
// Layout. Grid (ceil(bm / kWarps), nr_tiles): a block owns kWarps queries
// of one R tile, one warp per query, so a 4096-query bucket (32 R tiles at
// bm = 128) gives 512 blocks for the 132 SMs instead of 32. The block reads
// its tile's count and schedule row itself (Hopper has no scalar prefetch)
// and stages each scheduled S tile in shared memory in row chunks, with the
// rows' norms and liveness. Each lane scans every 32nd row of the chunk
// into its own ascending KP-run in registers (csrc/sorted_run.cuh); at the
// end the warp merges its 32 runs and lane 0 writes the row.
//
// What bounds it on this card. Per (query, row) pair it does d fp32 FMAs
// (2·d flops) plus d shared-memory reads, while a staged row (4·d bytes) is shared by
// the block's kWarps queries and the visited S tiles stay in the 50 MB L2.
// So it is bound by FMA and shared-memory throughput, not by HBM.
//
// This is the simple, correct first version: fp32 CUDA-core FMAs (no TF32:
// the selection must not lose a true neighbor to TF32 noise), no wgmma, no
// TMA or cp.async double buffering. Those come in later PRs.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "sorted_run.cuh"

namespace {

using repro_torch::run_init;
using repro_torch::run_insert;
using repro_torch::warp_merge_flush;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBytes = 48 * 1024;

template <int KP, int MAXD>
__global__ void __launch_bounds__(kThreads)
gather_topk_kernel(const float* __restrict__ r, const float* __restrict__ s,
                   const int* __restrict__ sched, const int* __restrict__ counts,
                   const float* __restrict__ alive, float* __restrict__ out_d,
                   int* __restrict__ out_p, int n_r, int n_s, int d, int k, int bm,
                   int bn, int max_visits, int chunk) {
  extern __shared__ float smem[];
  const int dp = d | 1;  // odd row stride: lanes reading rows 32 apart hit distinct banks
  float* s_rows = smem;                                        // chunk x dp
  float* s_norm = smem + static_cast<size_t>(chunk) * dp;      // chunk; -1 marks a dead row

  const int tile_r = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_local = blockIdx.x * kWarps + warp;
  const long long row = static_cast<long long>(tile_r) * bm + q_local;
  const bool active = q_local < bm && row < n_r;  // uniform across the warp
  const int ns_tiles = (n_s + bn - 1) / bn;

  float q[MAXD];
  float qn = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    q[j] = 0.f;
    if (active && j < d) q[j] = r[row * d + j];
  }
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d) qn = fmaf(q[j], q[j], qn);
  }

  float rd[KP];
  int rp[KP];
  run_init(rd, rp);

  const int cnt = min(counts[tile_r], max_visits);
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;
  for (int v = 0; v < cnt; ++v) {
    const int t = srow[v];
    if (t < 0 || t >= ns_tiles) continue;  // out-of-range entry: nothing to read (block-uniform)
    const long long base = static_cast<long long>(t) * bn;
    for (int c0 = 0; c0 < bn; c0 += chunk) {
      const int rows = min(chunk, bn - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < rows * d; e += kThreads) {
        const int rr = e / d;
        const int j = e - rr * d;
        const long long g = base + c0 + rr;
        s_rows[rr * dp + j] = g < n_s ? s[g * d + j] : 0.f;
      }
      __syncthreads();
      for (int rr = threadIdx.x; rr < rows; rr += kThreads) {
        const long long g = base + c0 + rr;
        const bool live = g < n_s && (alive == nullptr || alive[g] > 0.f);
        const float* sr = s_rows + rr * dp;
        float sn = 0.f;
        for (int j = 0; j < d; ++j) sn = fmaf(sr[j], sr[j], sn);
        s_norm[rr] = live ? sn : -1.f;
      }
      __syncthreads();
      if (active) {
        for (int rr = lane; rr < rows; rr += 32) {
          const float sn = s_norm[rr];
          if (sn < 0.f) continue;
          const float* sr = s_rows + rr * dp;
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < MAXD; ++j) {
            if (j < d) dot = fmaf(q[j], sr[j], dot);
          }
          const float d2 = fmaxf((qn + sn) - 2.f * dot, 0.f);
          run_insert(rd, rp, d2, static_cast<int>(base + c0 + rr));
        }
      }
    }
  }
  if (!active) return;
  warp_merge_flush(rd, rp, k, out_d + row * k, out_p + row * k);
}

template <int KP, int MAXD>
cudaError_t launch(const float* r, const float* s, const int* sched, const int* counts,
                   const float* alive, float* out_d, int* out_p, int n_r, int n_s, int d,
                   int k, int bm, int bn, int nr_tiles, int max_visits, cudaStream_t stream) {
  const int dp = d | 1;
  const int chunk = std::min(bn, kSmemBytes / static_cast<int>(sizeof(float) * (dp + 1)));
  const size_t smem = static_cast<size_t>(chunk) * (dp + 1) * sizeof(float);
  const dim3 grid((bm + kWarps - 1) / kWarps, nr_tiles);
  gather_topk_kernel<KP, MAXD><<<grid, kThreads, smem, stream>>>(
      r, s, sched, counts, alive, out_d, out_p, n_r, n_s, d, k, bm, bn, max_visits, chunk);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_d(const float* r, const float* s, const int* sched, const int* counts,
                     const float* alive, float* out_d, int* out_p, int n_r, int n_s, int d,
                     int k, int bm, int bn, int nr_tiles, int max_visits, cudaStream_t stream) {
  if (d <= 16)
    return launch<KP, 16>(r, s, sched, counts, alive, out_d, out_p, n_r, n_s, d, k, bm, bn,
                          nr_tiles, max_visits, stream);
  if (d <= 32)
    return launch<KP, 32>(r, s, sched, counts, alive, out_d, out_p, n_r, n_s, d, k, bm, bn,
                          nr_tiles, max_visits, stream);
  if (d <= 64)
    return launch<KP, 64>(r, s, sched, counts, alive, out_d, out_p, n_r, n_s, d, k, bm, bn,
                          nr_tiles, max_visits, stream);
  return launch<KP, 128>(r, s, sched, counts, alive, out_d, out_p, n_r, n_s, d, k, bm, bn,
                         nr_tiles, max_visits, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for shapes the
// kernel does not take: 1 <= d <= 128, 1 <= k <= 64, bm, bn >= 1).
// The run width is max(8, next_pow2(k)): the first k entries of the top-8
// run are the top-k, so small k share the KP = 8 instantiation.
extern "C" int repro_gather_topk(const void* r, const void* s, const void* sched,
                                 const void* counts, const void* alive, void* out_d,
                                 void* out_p, int n_r, int n_s, int d, int k, int bm, int bn,
                                 int nr_tiles, int max_visits, void* stream) {
  if (d < 1 || d > 128 || k < 1 || k > 64 || bm < 1 || bn < 1 || max_visits < 1 ||
      n_r < 1 || n_s < 1 || nr_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* sf = static_cast<const float*>(s);
  const auto* sc = static_cast<const int*>(sched);
  const auto* cn = static_cast<const int*>(counts);
  const auto* al = static_cast<const float*>(alive);
  auto* od = static_cast<float*>(out_d);
  auto* op = static_cast<int*>(out_p);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 8)
    err = launch_d<8>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  else if (k <= 16)
    err = launch_d<16>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  else if (k <= 32)
    err = launch_d<32>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  else
    err = launch_d<64>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  return static_cast<int>(err);
}
