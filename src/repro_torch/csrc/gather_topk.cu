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
// entries and their int32 positions; an empty slot is (+inf, -1). ‖r‖², ‖s‖²
// and r·s are each one fmaf chain in ascending j, so every route and every
// cut of the grid below reports the same bits and positions.
//
// What bounds it on this card. Per (query, row) pair, d fp32 FMAs plus the
// norm, clamp and run compare; a visited S tile is read from L2 by every
// block of its R tile. So it is bound by issue and fp32 throughput, never by
// HBM except where few queries share a huge schedule (a kNN-LM decode step:
// 8 queries over 1,048,576 keys, bound by reading them once).
//
// The design:
// - One block walking an R tile's whole schedule row alone would run a
//   decode batch (one R tile) on one block, and let long schedule rows set
//   the pace of a bucket. So each R tile's schedule row is cut into `splits`
//   contiguous visit ranges of `per` slots; each (query block, R tile,
//   split) is one block (grid z), which writes its partial KP-run of
//   (d², position) to scratch, and a merge pass (a warp per query, as K-D's)
//   folds the splits in (d², position) order and writes √d². The split
//   count comes on the host from static shapes only (kernels/
//   distance_topk.py, plan_gather: ~4 blocks per SM), so the steady state
//   makes no host sync. A split whose range lies past counts[i] writes an
//   empty run. Selection is exact (a total order on unique positions), so
//   every split count gives the same bits.
// - One shared-memory load per FMA (a warp per query, one row value a
//   load) would cap the fp32 pipe. So a staged row is laid out with a
//   16-byte-aligned stride (≡ 4 words mod 8: eight lanes' 16-byte loads
//   hit 32 distinct banks), a lane reads 4 of its row's values with one
//   16-byte load, each lane keeps a sorted KP-run per query in registers
//   (csrc/sorted_run.cuh) merged by the warp at the end, and a warp
//   serves QW queries (2 where the runs and the query fit in registers:
//   KP <= 16 and d <= 32), so one load feeds 4·QW FMAs. Each dot is still
//   its own ascending fmaf chain.
// - Blocks with no live query (7 of the 8 query blocks of a 128-row R tile
//   that a decode batch of 8 occupies) exit before staging anything.
// - Where a warp serves 2 queries, a block has 16 warps where the batch
//   fills them (a Forest bucket: 32 queries share each staged chunk), 8 for
//   a small batch, and the form is held to 128 registers a thread (16 warps
//   per SM). The one-query forms (KP > 16 or d > 32) keep 8 warps and up to
//   255 registers, so their wide runs and queries do not spill. The wrapper's
//   plan chooses the form; a query's width is instantiated at 12, 16, 32, 64
//   or 128.
// - S chunks and their rows' alive values are staged with cp.async (16-byte
//   copies where rows are aligned, else 4-byte) into a double buffer: the
//   next chunk's copies are in flight while this one's norms and distances
//   are computed. A staged row's norm and liveness are computed once per
//   block, from shared memory only.
//
// Any width, any k. The register kernel takes d <= 128 and k <= 64 (a KP-run
// per lane per query). Past either, the general kernel runs on the same
// split grid: it stages the S rows 64 at a time and both the rows and the
// block's 8 queries one 32-wide chunk of d at a time (as K-D does), each
// lane accumulating the dot products of two rows across the chunks, and
// keeps each query's run in a warp-wide run of exactly k entries in device
// memory (csrc/wide_run.cuh); its partial runs are wide runs, and the merge
// folds them through a wide run.
//
// No TF32 and no tensor cores: the selection must not lose a true neighbour
// to rounding noise, and must stay bitwise equal across routes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sorted_run.cuh"
#include "wide_run.cuh"

namespace {

using repro_torch::run_before;
using repro_torch::run_init;
using repro_torch::run_insert;
using repro_torch::warp_merge_flush;
using repro_torch::WideRun;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = 96 * 1024;  // the register kernel's two chunk buffers
constexpr int kRC = 64;   // S rows per chunk of the general kernel (two per lane)
constexpr int kDC = 32;   // width of one staged chunk of d
constexpr int kCap = 64;  // candidate buffer of a warp's wide run

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A warp's merge of its 32 lane runs into the split's partial run: KP
// entries of (d², position), ascending, at out_d / out_p.
template <int KP>
__device__ __forceinline__ void warp_merge_partial(float (&rd)[KP], int (&rp)[KP],
                                                   float* out_d, int* out_p) {
  const int lane = threadIdx.x & 31;
  for (int o = 0; o < KP; ++o) {
    float bd = rd[0];
    int bp = rp[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (run_before(od, op, bd, bp)) {
        bd = od;
        bp = op;
      }
    }
    if (lane == 0) {
      out_d[o] = bd;
      out_p[o] = bp;
    }
    if (rp[0] == bp) {  // positions are unique; an empty winner pops empties only
#pragma unroll
      for (int j = 0; j + 1 < KP; ++j) {
        rd[j] = rd[j + 1];
        rp[j] = rp[j + 1];
      }
      rd[KP - 1] = CUDART_INF_F;
      rp[KP - 1] = -1;
    }
  }
}

// The register kernel's forms: a warp serves QW queries, a block has WARPS
// warps. Two queries a warp (runs and queries twice in registers) are held to
// 128 registers a thread, 16 warps an SM; one query a warp keeps up to 255.
template <int KP, int MAXD, int QW, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, QW == 2 ? 16 / WARPS : 1)
gather_topk_kernel(const float* __restrict__ r, const float* __restrict__ s,
                   const int* __restrict__ sched, const int* __restrict__ counts,
                   const float* __restrict__ alive, float* __restrict__ out_d,
                   int* __restrict__ out_p, float* __restrict__ part_d, int* __restrict__ part_p,
                   int n_r, int n_s, int d, int k, int bm, int bn, int max_visits, int per,
                   int chunk, int sp, int vec) {
  constexpr int kT = WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  float* s_rows = smem;                                     // 2 x chunk x sp
  float* s_norm = smem + 2 * static_cast<size_t>(chunk) * sp;  // 2 x chunk; -1 marks a dead row
  float* s_alive = s_norm + 2 * chunk;                          // 2 x chunk: the rows' alive

  const int tile_r = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qb0 = blockIdx.x * (WARPS * QW);
  const long long row0 = static_cast<long long>(tile_r) * bm;
  if (qb0 >= bm || row0 + qb0 >= n_r) return;  // block-uniform: no live query, nothing to stage

  float q[QW][MAXD];
  float qn[QW];
  bool act[QW];
  long long row[QW];
#pragma unroll
  for (int qq = 0; qq < QW; ++qq) {
    const int ql = qb0 + warp * QW + qq;
    row[qq] = row0 + ql;
    act[qq] = ql < bm && row[qq] < n_r;  // uniform across the warp
    qn[qq] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXD; ++j) q[qq][j] = (act[qq] && j < d) ? r[row[qq] * d + j] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < d) qn[qq] = fmaf(q[qq][j], q[qq][j], qn[qq]);
  }
  bool any_act = false;
#pragma unroll
  for (int qq = 0; qq < QW; ++qq) any_act = any_act || act[qq];

  float rd[QW][KP];
  int rp[QW][KP];
#pragma unroll
  for (int qq = 0; qq < QW; ++qq) run_init(rd[qq], rp[qq]);

  const int cnt = min(counts[tile_r], max_visits);
  const int v_lo = split * per;
  const int v_hi = min(cnt, v_lo + per);
  const int cpt = (bn + chunk - 1) / chunk;  // chunks per S tile
  const int n_items = v_hi > v_lo ? (v_hi - v_lo) * cpt : 0;
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;
  const int ns_tiles = (n_s + bn - 1) / bn;

  // item i: chunk i % cpt of the S tile in slot v_lo + i / cpt; rows 0 for
  // an out-of-range entry (nothing to read)
  auto item_rows = [&](int item, long long* base) {
    const int t = srow[v_lo + item / cpt];
    const int c0 = (item % cpt) * chunk;
    *base = static_cast<long long>(t) * bn + c0;
    return (t < 0 || t >= ns_tiles) ? 0 : min(chunk, bn - c0);
  };
  auto stage = [&](int item, int buf) {
    long long base;
    const int rows = item_rows(item, &base);
    float* dst = s_rows + static_cast<size_t>(buf) * chunk * sp;
    if (alive != nullptr) {
      for (int rr = tid; rr < rows; rr += kT) {
        const bool ok = base + rr < n_s;
        cp_async4(s_alive + buf * chunk + rr, ok ? alive + base + rr : alive, ok ? 4 : 0);
      }
    }
    if (vec) {
      const int c4 = d >> 2;
      for (int e = tid; e < rows * c4; e += kT) {
        const int rr = e / c4;
        const int j = (e - rr * c4) * 4;
        const long long g = base + rr;
        const bool ok = g < n_s;
        cp_async16(dst + rr * sp + j, ok ? s + g * d + j : s, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * d; e += kT) {
        const int rr = e / d;
        const int j = e - rr * d;
        const long long g = base + rr;
        const bool ok = g < n_s;
        cp_async4(dst + rr * sp + j, ok ? s + g * d + j : s, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (n_items > 0) stage(0, 0);
  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the other buffer's scan is done
    if (it + 1 < n_items) stage(it + 1, buf ^ 1);
    long long base;
    const int rows = item_rows(it, &base);
    const float* rows_s = s_rows + static_cast<size_t>(buf) * chunk * sp;
    float* norm_s = s_norm + buf * chunk;
    for (int rr = tid; rr < rows; rr += kT) {
      const bool live = base + rr < n_s && (alive == nullptr || s_alive[buf * chunk + rr] > 0.f);
      const float* sr = rows_s + rr * sp;
      float sn = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < MAXD / 4; ++j4) {
        if (4 * j4 < d) {
          const float4 v4 = *reinterpret_cast<const float4*>(sr + 4 * j4);
          const float sv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * j4 + e < d) sn = fmaf(sv[e], sv[e], sn);
        }
      }
      norm_s[rr] = live ? sn : -1.f;
    }
    __syncthreads();
    if (!any_act) continue;  // warp-uniform
    for (int rr = lane; rr < rows; rr += 32) {
      const float sn = norm_s[rr];
      if (sn < 0.f) continue;
      const float* sr = rows_s + rr * sp;
      float dot[QW];
#pragma unroll
      for (int qq = 0; qq < QW; ++qq) dot[qq] = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < MAXD / 4; ++j4) {
        if (4 * j4 < d) {
          const float4 v4 = *reinterpret_cast<const float4*>(sr + 4 * j4);
          const float sv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * j4 + e < d) {
#pragma unroll
              for (int qq = 0; qq < QW; ++qq) dot[qq] = fmaf(q[qq][4 * j4 + e], sv[e], dot[qq]);
            }
          }
        }
      }
      const int pos = static_cast<int>(base + rr);
#pragma unroll
      for (int qq = 0; qq < QW; ++qq) {
        if (act[qq]) run_insert(rd[qq], rp[qq], fmaxf((qn[qq] + sn) - 2.f * dot[qq], 0.f), pos);
      }
    }
  }

#pragma unroll
  for (int qq = 0; qq < QW; ++qq) {
    if (!act[qq]) continue;  // warp-uniform
    if (part_d == nullptr)
      warp_merge_flush(rd[qq], rp[qq], k, out_d + row[qq] * k, out_p + row[qq] * k);
    else
      warp_merge_partial(rd[qq], rp[qq], part_d + (split * static_cast<long long>(n_r) + row[qq]) * KP,
                         part_p + (split * static_cast<long long>(n_r) + row[qq]) * KP);
  }
}

// The general kernel: any d, any k (see the header). part_d / part_p hold
// two buffers of k entries per (split, query row) (the wide run's
// ping-pong pair); with one split the run is written out as (√d², position)
// at the end, with several the split's run is left in the first buffer.
__global__ void __launch_bounds__(kThreads)
gather_topk_general(const float* __restrict__ r, const float* __restrict__ s,
                    const int* __restrict__ sched, const int* __restrict__ counts,
                    const float* __restrict__ alive, float* __restrict__ out_d,
                    int* __restrict__ out_p, float* __restrict__ part_d, int* __restrict__ part_p,
                    int n_r, int n_s, int d, int k, int bm, int bn, int max_visits, int per,
                    int splits) {
  __shared__ float q_s[kWarps][kDC + 1];
  __shared__ float s_s[kRC][kDC + 1];
  __shared__ float sn_s[kRC];  // -1 marks a dead or missing row
  __shared__ float buf_d[kWarps][kCap];
  __shared__ int buf_p[kWarps][kCap];

  const int tile_r = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qb0 = blockIdx.x * kWarps;
  if (qb0 >= bm || static_cast<long long>(tile_r) * bm + qb0 >= n_r) return;  // no live query
  const int q_local = qb0 + warp;
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
  float* rd = part_d + (split * static_cast<long long>(n_r) + row) * 2LL * k;
  int* rp = part_p + (split * static_cast<long long>(n_r) + row) * 2LL * k;
  if (active) run.init(rd, rp, rd + k, rp + k, buf_d[warp], buf_p[warp], k);

  const int cnt = min(counts[tile_r], max_visits);
  const int v_hi = min(cnt, split * per + per);
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;
  for (int v = split * per; v < v_hi; ++v) {
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
          const long long qrow = static_cast<long long>(tile_r) * bm + qb0 + w;
          const bool ok = qb0 + w < bm && qrow < n_r && j < dk;
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
  if (splits == 1) {
    for (int i = lane; i < k; i += 32) {
      const int p = kp[i];
      out_d[row * k + i] = p < 0 ? CUDART_INF_F : sqrtf(kd[i]);
      out_p[row * k + i] = p;
    }
  } else if (run.cur == 1) {  // the run ends in the second buffer: move it to the first
    for (int i = lane; i < k; i += 32) {
      rd[i] = rd[k + i];
      rp[i] = rp[k + i];
    }
  }
}

// A warp per query folds the splits' partial runs (KP entries each) into
// one and writes the first k entries as (√d², position).
template <int KP>
__global__ void __launch_bounds__(kThreads)
gather_topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_p,
                  float* __restrict__ out_d, int* __restrict__ out_p, int n_r, int k, int splits) {
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (q >= n_r) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  float rd[KP];
  int rp[KP];
  run_init(rd, rp);
  const int n = splits * KP;
  for (int e = lane; e < n; e += 32) {
    const int sp = e / KP;
    const long long at = (static_cast<long long>(sp) * n_r + q) * KP + (e - sp * KP);
    const int p = part_p[at];
    if (p >= 0) run_insert(rd, rp, part_d[at], p);
  }
  warp_merge_flush(rd, rp, k, out_d + q * k, out_p + q * k);
}

// A warp per query folds the splits' wide partial runs (rows of 2k, the
// first k the run) through a wide run in scratch (n_r x 2k) and writes
// (√d², position).
__global__ void __launch_bounds__(kThreads)
gather_topk_merge_wide(const float* __restrict__ part_d, const int* __restrict__ part_p,
                       float* __restrict__ scratch_d, int* __restrict__ scratch_p,
                       float* __restrict__ out_d, int* __restrict__ out_p, int n_r, int k,
                       int splits) {
  __shared__ float buf_d[kWarps][kCap];
  __shared__ int buf_p[kWarps][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (q >= n_r) return;  // warp-uniform
  WideRun<kCap> run;
  run.init(scratch_d + q * 2LL * k, scratch_p + q * 2LL * k, scratch_d + q * 2LL * k + k,
           scratch_p + q * 2LL * k + k, buf_d[warp], buf_p[warp], k);
  for (int sp = 0; sp < splits; ++sp) {
    const long long at = (static_cast<long long>(sp) * n_r + q) * 2LL * k;
    for (int i0 = 0; i0 < k; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < k;
      const float dd = ok ? part_d[at + i] : 0.f;
      const int pp = ok ? part_p[at + i] : -1;
      run.offer(dd, pp, ok && pp >= 0);
    }
  }
  run.flush();
  const float* kd = run.keys();
  const int* kp = run.positions();
  for (int i = lane; i < k; i += 32) {
    const int p = kp[i];
    out_d[q * k + i] = p < 0 ? CUDART_INF_F : sqrtf(kd[i]);
    out_p[q * k + i] = p;
  }
}

struct Launch {
  const float *r, *s;
  const int *sched, *counts;
  const float* alive;
  float* out_d;
  int* out_p;
  float* part_d;
  int* part_p;
  int n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, warps, qw, splits, per;
  cudaStream_t stream;
};

template <int KP, int MAXD, int QW, int WARPS>
cudaError_t launch_w(const Launch& L) {
  constexpr int QB = WARPS * QW;
  int sp = (L.d + 3) & ~3;           // a 16-byte-aligned row stride ...
  if ((sp >> 2) % 2 == 0) sp += 4;   // ... of an odd number of 16-byte units
  int chunk = kStageBytes / (2 * 4 * (sp + 2));
  chunk = chunk >= 32 ? chunk & ~31 : 32;
  if (chunk > L.bn) chunk = L.bn;
  const size_t smem = 2 * static_cast<size_t>(chunk) * (sp + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gather_topk_kernel<KP, MAXD, QW, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec = (L.d % 4 == 0) && (reinterpret_cast<uintptr_t>(L.s) % 16 == 0);
  const bool merged = L.splits > 1;
  const dim3 grid((L.bm + QB - 1) / QB, L.nr_tiles, L.splits);
  gather_topk_kernel<KP, MAXD, QW, WARPS><<<grid, WARPS * 32, smem, L.stream>>>(
      L.r, L.s, L.sched, L.counts, L.alive, L.out_d, L.out_p, merged ? L.part_d : nullptr,
      merged ? L.part_p : nullptr, L.n_r, L.n_s, L.d, L.k, L.bm, L.bn, L.max_visits, L.per,
      chunk, sp, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merged) return err;
  gather_topk_merge<KP><<<(L.n_r + kWarps - 1) / kWarps, kThreads, 0, L.stream>>>(
      L.part_d, L.part_p, L.out_d, L.out_p, L.n_r, L.k, L.splits);
  return cudaGetLastError();
}

// The form the wrapper's plan chose, among those built: two queries a warp
// (8 or 16 warps) where KP <= 16 and the query's width is at most 32, else
// one query a warp (8 warps).
template <int KP, int MAXD>
cudaError_t launch(const Launch& L) {
  if constexpr (KP <= 16 && MAXD <= 32) {
    if (L.qw == 2 && L.warps == 8) return launch_w<KP, MAXD, 2, 8>(L);
    if (L.qw == 2 && L.warps == 16) return launch_w<KP, MAXD, 2, 16>(L);
  } else {
    if (L.qw == 1 && L.warps == 8) return launch_w<KP, MAXD, 1, 8>(L);
  }
  return cudaErrorInvalidValue;
}

template <int KP>
cudaError_t launch_d(const Launch& L) {
  if (L.d <= 12) return launch<KP, 12>(L);  // Forest CoverType's d = 10: 4 registers a query less
  if (L.d <= 16) return launch<KP, 16>(L);
  if (L.d <= 32) return launch<KP, 32>(L);
  if (L.d <= 64) return launch<KP, 64>(L);
  return launch<KP, 128>(L);
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for what the
// kernel does not take: d, k, bm, bn, max_visits, splits, per >= 1,
// splits·per >= max_visits, a (qw, warps) form that is not built). The grid
// is (ceil(bm / (warps·qw)), nr_tiles, splits); split i covers schedule
// slots [i·per, (i+1)·per). d <= 128 with k <= 64 runs the register kernel,
// with a run width KP = max(8, next_pow2(k)) and the form (qw, warps) the
// caller chose; with splits > 1 its partial runs go to part_d / part_p
// (splits x n_r x KP) and a merge pass writes out_d / out_p. Anything wider
// runs the general kernel (qw = 1, warps = 8), whose wide runs live in
// part_d / part_p (splits x n_r x 2k, always needed) and, with splits > 1,
// are merged through scratch_d / scratch_p (n_r x 2k).
extern "C" int repro_gather_topk(const void* r, const void* s, const void* sched,
                                 const void* counts, const void* alive, void* out_d,
                                 void* out_p, void* part_d, void* part_p, void* scratch_d,
                                 void* scratch_p, int n_r, int n_s, int d, int k, int bm, int bn,
                                 int nr_tiles, int max_visits, int warps, int qw, int splits,
                                 int per,
                                 void* stream) {
  if (d < 1 || k < 1 || bm < 1 || bn < 1 || max_visits < 1 || n_r < 1 || n_s < 1 ||
      nr_tiles < 1 || splits < 1 || splits > 65535 || per < 1 ||
      static_cast<long long>(splits) * per < max_visits)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch L{static_cast<const float*>(r), static_cast<const float*>(s),
           static_cast<const int*>(sched), static_cast<const int*>(counts),
           static_cast<const float*>(alive), static_cast<float*>(out_d),
           static_cast<int*>(out_p), static_cast<float*>(part_d), static_cast<int*>(part_p),
           n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, warps, qw, splits, per,
           static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (d > 128 || k > 64) {
    if (qw != 1 || warps != kWarps || part_d == nullptr || part_p == nullptr ||
        (splits > 1 && (scratch_d == nullptr || scratch_p == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((bm + kWarps - 1) / kWarps, nr_tiles, splits);
    gather_topk_general<<<grid, kThreads, 0, L.stream>>>(
        L.r, L.s, L.sched, L.counts, L.alive, L.out_d, L.out_p, L.part_d, L.part_p, n_r, n_s, d,
        k, bm, bn, max_visits, per, splits);
    err = cudaGetLastError();
    if (err == cudaSuccess && splits > 1) {
      gather_topk_merge_wide<<<(n_r + kWarps - 1) / kWarps, kThreads, 0, L.stream>>>(
          L.part_d, L.part_p, static_cast<float*>(scratch_d), static_cast<int*>(scratch_p),
          L.out_d, L.out_p, n_r, k, splits);
      err = cudaGetLastError();
    }
    return static_cast<int>(err);
  }
  if (splits > 1 && (part_d == nullptr || part_p == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 8)
    err = launch_d<8>(L);
  else if (k <= 16)
    err = launch_d<16>(L);
  else if (k <= 32)
    err = launch_d<32>(L);
  else
    err = launch_d<64>(L);
  return static_cast<int>(err);
}
