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
// Any width, any k. The query-in-registers layout above takes d <= 128 and
// k <= 64 (a KP-run per lane). Past either, a second kernel runs on the same
// grid: it stages the S rows 64 at a time and both the rows and the block's
// kWarps queries one 32-wide chunk of d at a time (as K-D does), each lane
// accumulating the dot products of two rows across the chunks, and keeps
// each query's run in a warp-wide run of exactly k entries in device memory
// (csrc/wide_run.cuh). Its d² chain is the register kernel's (‖r‖², ‖s‖² and
// r·s each one fmaf chain in ascending j), so both kernels report the same
// bits and the same positions.
//
// This is the simple, correct first version: fp32 CUDA-core FMAs (no TF32:
// the selection must not lose a true neighbor to TF32 noise), no wgmma, no
// TMA or cp.async double buffering. Those come in later PRs.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "sorted_run.cuh"
#include "wide_run.cuh"

namespace {

using repro_torch::run_init;
using repro_torch::run_insert;
using repro_torch::warp_merge_flush;
using repro_torch::WideRun;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kRC = 64;   // S rows per chunk of the general kernel (two per lane)
constexpr int kDC = 32;   // width of one staged chunk of d
constexpr int kCap = 64;  // candidate buffer of a warp's wide run

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

// The general kernel: any d, any k (see the header). run_d / run_p hold two
// buffers of k entries per query row (the wide run's ping-pong pair).
__global__ void __launch_bounds__(kThreads)
gather_topk_general(const float* __restrict__ r, const float* __restrict__ s,
                    const int* __restrict__ sched, const int* __restrict__ counts,
                    const float* __restrict__ alive, float* __restrict__ out_d,
                    int* __restrict__ out_p, float* __restrict__ run_d, int* __restrict__ run_p,
                    int n_r, int n_s, int d, int k, int bm, int bn, int max_visits) {
  __shared__ float q_s[kWarps][kDC + 1];
  __shared__ float s_s[kRC][kDC + 1];
  __shared__ float sn_s[kRC];  // -1 marks a dead or missing row
  __shared__ float buf_d[kWarps][kCap];
  __shared__ int buf_p[kWarps][kCap];

  const int tile_r = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_local = blockIdx.x * kWarps + warp;
  const long long row = static_cast<long long>(tile_r) * bm + q_local;
  const bool active = q_local < bm && row < n_r;  // uniform across the warp
  const int ns_tiles = (n_s + bn - 1) / bn;

  // ‖r‖²: one fmaf chain in ascending j, as the register kernel's
  float qn = 0.f;
  if (active && lane == 0) {
    const float* qr = r + row * d;
    for (int j = 0; j < d; ++j) qn = fmaf(qr[j], qr[j], qn);
  }
  qn = __shfl_sync(0xffffffffu, qn, 0);

  WideRun<kCap> run;
  if (active) {
    float* rd = run_d + row * 2LL * k;
    int* rp = run_p + row * 2LL * k;
    run.init(rd, rp, rd + k, rp + k, buf_d[warp], buf_p[warp], k);
  }

  const int cnt = min(counts[tile_r], max_visits);
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;
  for (int v = 0; v < cnt; ++v) {
    const int t = srow[v];
    if (t < 0 || t >= ns_tiles) continue;  // out-of-range entry: nothing to read (block-uniform)
    const long long base = static_cast<long long>(t) * bn;
    for (int c0 = 0; c0 < bn; c0 += kRC) {
      const int rows = min(kRC, bn - c0);
      float acc0 = 0.f, acc1 = 0.f, sn = 0.f;
      for (int k0 = 0; k0 < d; k0 += kDC) {
        const int dk = min(kDC, d - k0);
        __syncthreads();  // the previous chunk (and selection) is consumed
        for (int e = tid; e < kWarps * kDC; e += kThreads) {
          const int w = e / kDC;
          const int j = e - w * kDC;
          const long long qrow = static_cast<long long>(tile_r) * bm + blockIdx.x * kWarps + w;
          const bool ok = blockIdx.x * kWarps + w < bm && qrow < n_r && j < dk;
          q_s[w][j] = ok ? r[qrow * d + k0 + j] : 0.f;
        }
        for (int e = tid; e < kRC * kDC; e += kThreads) {
          const int i = e / kDC;
          const int j = e - i * kDC;
          const long long g = base + c0 + i;
          s_s[i][j] = (i < rows && j < dk && g < n_s) ? s[g * d + k0 + j] : 0.f;
        }
        __syncthreads();
        if (tid < kRC) {
          for (int j = 0; j < dk; ++j) sn = fmaf(s_s[tid][j], s_s[tid][j], sn);
        }
        for (int j = 0; j < dk; ++j) {
          const float qj = q_s[warp][j];
          acc0 = fmaf(qj, s_s[lane][j], acc0);
          acc1 = fmaf(qj, s_s[lane + 32][j], acc1);
        }
      }
      if (tid < kRC) {
        const long long g = base + c0 + tid;
        const bool live = tid < rows && g < n_s && (alive == nullptr || alive[g] > 0.f);
        sn_s[tid] = live ? sn : -1.f;
      }
      __syncthreads();
      if (active) {
        const float sn0 = sn_s[lane], sn1 = sn_s[lane + 32];
        run.offer(fmaxf((qn + sn0) - 2.f * acc0, 0.f), static_cast<int>(base + c0 + lane),
                  sn0 >= 0.f);
        run.offer(fmaxf((qn + sn1) - 2.f * acc1, 0.f), static_cast<int>(base + c0 + lane + 32),
                  sn1 >= 0.f);
      }
    }
  }
  if (!active) return;
  run.flush();
  const float* kd = run.keys();
  const int* kp = run.positions();
  for (int i = lane; i < k; i += 32) {
    const int p = kp[i];
    out_d[row * k + i] = p < 0 ? CUDART_INF_F : sqrtf(kd[i]);
    out_p[row * k + i] = p;
  }
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
// kernel does not take: d, k, bm, bn >= 1). d <= 128 with k <= 64 runs the
// register kernel, with a run width of max(8, next_pow2(k)) (the first k
// entries of the top-8 run are the top-k, so small k share the KP = 8
// instantiation); anything wider runs the general kernel, whose wide runs
// live in run_d / run_p (n_r x 2k entries each; unused, and may be null,
// otherwise).
extern "C" int repro_gather_topk(const void* r, const void* s, const void* sched,
                                 const void* counts, const void* alive, void* out_d,
                                 void* out_p, void* run_d, void* run_p, int n_r, int n_s, int d,
                                 int k, int bm, int bn, int nr_tiles, int max_visits,
                                 void* stream) {
  if (d < 1 || k < 1 || bm < 1 || bn < 1 || max_visits < 1 || n_r < 1 || n_s < 1 ||
      nr_tiles < 1)
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
  if (d > 128 || k > 64) {
    if (run_d == nullptr || run_p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((bm + kWarps - 1) / kWarps, nr_tiles);
    gather_topk_general<<<grid, kThreads, 0, st>>>(
        rf, sf, sc, cn, al, od, op, static_cast<float*>(run_d), static_cast<int*>(run_p), n_r,
        n_s, d, k, bm, bn, max_visits);
    err = cudaGetLastError();
  } else if (k <= 8)
    err = launch_d<8>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  else if (k <= 16)
    err = launch_d<16>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  else if (k <= 32)
    err = launch_d<32>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  else
    err = launch_d<64>(rf, sf, sc, cn, al, od, op, n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, st);
  return static_cast<int>(err);
}
