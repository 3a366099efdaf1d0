// Dense L2 top-k with an optional per-tile visit mask for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel distance_topk_kernel
// (src/repro/kernels/distance_topk.py:71, wrapper distance_topk_pallas :101,
// pallas_call at :129).
//
// What it computes. For every row of r, the k smallest
//   d² = (‖r‖² + ‖s‖²) − 2·r·s, clamped at 0,
// over the rows of every S tile (bn rows) whose visit_mask[R tile, S tile]
// entry is non-zero (R tiles are bm rows; no mask = every tile). It writes
// √d² ascending and the int32 row ids; an empty slot is (+inf, -1). Ties in
// d² go to the lower row id.
//
// What bounds it on this card. Per (query, row) pair it does d fp32 FMAs
// plus the norm, clamp and compare: 2d + 3 operations, against 4d bytes per
// row that are read once per block of 32 queries. At the retrieval shapes
// (d = 10 with 4,096 queries, d = 1,024 with 256) the fp32 operations at
// 67 TFLOP/s bound it, not HBM.
//
// The design, and what it does about the TPU kernel's assumptions:
// - Width. The TPU kernel holds whole (bm, d) and (bn, d) tiles in VMEM, so
//   d is limited by VMEM only, and retrieval keys are LM hidden states
//   (d in the thousands). Here nothing of a row lives in registers: a block
//   stages its 32 queries and 64 S rows in shared memory one 32-wide chunk
//   of d at a time and accumulates a 2 x 4 register tile of dot products per
//   thread (SGEMM style), so any d >= 1 runs in 22 KB of shared memory.
// - Sequential grid. The TPU carries each R tile's run across the S grid
//   axis in VMEM scratch; Hopper's blocks are unordered. A block owns 32
//   queries and one contiguous range of S tiles (a split); each query's
//   candidates are scanned by 8 lanes, each keeping its own ascending
//   KP-run in registers (csrc/sorted_run.cuh). At the end of its range the
//   8 runs merge into one, written as a partial run; a second kernel merges
//   the splits' partial runs per query (a warp per query) and writes √d².
// - Small batches. A decode batch of a few hundred queries is 1-2 R tiles;
//   splitting the S axis (the wrapper picks the split count for ~4 blocks
//   per SM) keeps all 132 SMs busy.
// - Visit mask. A masked tile is skipped before any of its rows is loaded
//   (the TPU kernel only elides its compute).
// - Precision. fp32 FMAs on CUDA cores, no TF32: TF32 noise could push a
//   true neighbour out of the run. Row offsets are 64-bit (n_s·d passes
//   2³¹ at 2.1 M keys of width 1,024).
//
// - Wide runs. Past k = 64 a run no longer fits in registers: the KP = 0
//   instantiation keeps each query's run in a warp-wide run of exactly k
//   entries in device memory (csrc/wide_run.cuh; a warp serves its 4
//   queries in turn), the partial runs are k wide, and the merge pass folds
//   them through a wide run too. The d² chain is the same in both.
//
// This is the simple, correct first version: no wgmma, no TMA or cp.async
// double buffering, the query chunk restaged for every 64 S rows.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "sorted_run.cuh"
#include "wide_run.cuh"

namespace {

using repro_torch::run_before;
using repro_torch::run_init;
using repro_torch::run_insert;
using repro_torch::warp_merge_flush;
using repro_torch::WideRun;

constexpr int kBQ = 32;       // queries per block
constexpr int kBS = 64;       // S rows per chunk
constexpr int kDK = 32;       // width of one staged chunk of d
constexpr int kThreads = 256;
constexpr int kGroup = 8;     // lanes that scan one query's candidates
constexpr int kDStride = kBS + 8;  // the 4 queries of a warp start 8 banks apart
constexpr int kCap = 64;           // candidate buffer of a wide run

// KP > 0: register runs of KP entries; KP == 0: wide runs of k entries, in
// part_d / part_p rows of 2k (the ping-pong pair; the first k hold the
// split's run when the kernel ends).

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }

template <int KP>
__global__ void __launch_bounds__(kThreads)
dense_topk_partial(const float* __restrict__ r, const float* __restrict__ s,
                   const signed char* __restrict__ mask, float* __restrict__ part_d,
                   int* __restrict__ part_p, int n_r, int n_s, int d, int k, int bm,
                   int bn, int ns_tiles, int sub_per_tile, int tiles_per_split) {
  __shared__ float q_s[kBQ][kDK + 1];
  __shared__ float s_s[kBS][kDK + 1];
  __shared__ float d_s[kBQ][kDStride];
  __shared__ float sn_s[kBS];
  __shared__ float qn_s[kBQ];
  constexpr bool kWide = KP == 0;
  constexpr int KR = kWide ? 1 : KP;
  __shared__ float wbuf_d[kWide ? kBQ : 1][kCap];
  __shared__ int wbuf_p[kWide ? kBQ : 1][kCap];

  const int tile_r = blockIdx.x / sub_per_tile;
  const int sub = blockIdx.x - tile_r * sub_per_tile;
  const int split = blockIdx.y;
  const long long q0 = static_cast<long long>(tile_r) * bm + sub * kBQ;
  const int nq = static_cast<int>(lmin(lmin(kBQ, bm - sub * kBQ), n_r - q0));
  if (nq <= 0) return;  // block-uniform: a sub-tile past the last query

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // ‖q‖²: a warp per query, lanes over d, then a butterfly sum
  for (int i = warp; i < kBQ; i += kThreads / 32) {
    float acc = 0.f;
    if (i < nq) {
      const float* qr = r + (q0 + i) * d;
      for (int j = lane; j < d; j += 32) acc = fmaf(qr[j], qr[j], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) qn_s[i] = acc;
  }

  // dot-product tile of this thread: queries 2·tq, 2·tq+1; rows tc + 16·m
  const int tq = tid >> 4;
  const int tc = tid & 15;
  // selection: this lane scans query sel_q's rows sel_c, sel_c + 8, ...
  const int sel_q = warp * 4 + (lane >> 3);
  const int sel_c = lane & (kGroup - 1);

  float rd[KR];
  int rp[KR];
  run_init(rd, rp);
  WideRun<kCap> wr[4];  // wide: the runs of this warp's queries warp * 4 + 0..3
  if constexpr (kWide) {
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int qi = warp * 4 + qq;
      if (qi < nq) {
        const long long at = (static_cast<long long>(split) * n_r + q0 + qi) * 2LL * k;
        wr[qq].init(part_d + at, part_p + at, part_d + at + k, part_p + at + k, wbuf_d[qi],
                    wbuf_p[qi], k);
      }
    }
  }

  const int t_begin = split * tiles_per_split;
  const int t_end = static_cast<int>(lmin(ns_tiles, t_begin + tiles_per_split));
  for (int t = t_begin; t < t_end; ++t) {
    // block-uniform: a masked tile is never loaded
    if (mask != nullptr && mask[static_cast<long long>(tile_r) * ns_tiles + t] == 0) continue;
    const long long tile0 = static_cast<long long>(t) * bn;
    const long long tile_end = lmin(n_s, tile0 + bn);
    for (long long c0 = tile0; c0 < tile_end; c0 += kBS) {
      const int rows = static_cast<int>(lmin(kBS, tile_end - c0));
      float acc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[a][m] = 0.f;
      float sn = 0.f;
      for (int k0 = 0; k0 < d; k0 += kDK) {
        const int dk = static_cast<int>(lmin(kDK, d - k0));
        __syncthreads();  // the previous chunk (and the previous selection) is consumed
        for (int e = tid; e < kBQ * kDK; e += kThreads) {
          const int i = e / kDK;
          const int j = e - i * kDK;
          q_s[i][j] = (i < nq && j < dk) ? r[(q0 + i) * d + k0 + j] : 0.f;
        }
        for (int e = tid; e < kBS * kDK; e += kThreads) {
          const int i = e / kDK;
          const int j = e - i * kDK;
          s_s[i][j] = (i < rows && j < dk) ? s[(c0 + i) * d + k0 + j] : 0.f;
        }
        __syncthreads();
        if (tid < kBS) {
          for (int j = 0; j < dk; ++j) sn = fmaf(s_s[tid][j], s_s[tid][j], sn);
        }
        for (int j = 0; j < dk; ++j) {
          const float a0 = q_s[2 * tq][j];
          const float a1 = q_s[2 * tq + 1][j];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float b = s_s[tc + 16 * m][j];
            acc[0][m] = fmaf(a0, b, acc[0][m]);
            acc[1][m] = fmaf(a1, b, acc[1][m]);
          }
        }
      }
      if (tid < kBS) sn_s[tid] = sn;
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int qi = 2 * tq + a;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = tc + 16 * m;
          d_s[qi][col] = (qi < nq && col < rows)
                             ? fmaxf((qn_s[qi] + sn_s[col]) - 2.f * acc[a][m], 0.f)
                             : CUDART_INF_F;
        }
      }
      __syncthreads();
      if constexpr (kWide) {
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int qi = warp * 4 + qq;
          if (qi < nq) {  // warp-uniform
            wr[qq].offer(d_s[qi][lane], static_cast<int>(c0 + lane), lane < rows);
            wr[qq].offer(d_s[qi][lane + 32], static_cast<int>(c0 + lane + 32), lane + 32 < rows);
          }
        }
      } else if (sel_q < nq) {
        for (int c = sel_c; c < rows; c += kGroup)
          run_insert(rd, rp, d_s[sel_q][c], static_cast<int>(c0 + c));
      }
    }
  }

  if constexpr (kWide) {
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int qi = warp * 4 + qq;
      if (qi < nq) {
        wr[qq].flush();
        if (wr[qq].cur == 1) {  // the run ends in the second buffer: move it to the first
          const long long at = (static_cast<long long>(split) * n_r + q0 + qi) * 2LL * k;
          for (int i = lane; i < k; i += 32) {
            part_d[at + i] = part_d[at + k + i];
            part_p[at + i] = part_p[at + k + i];
          }
        }
      }
    }
    return;
  }

  // merge the 8 runs of each query (a butterfly over the lane group) and
  // write the split's partial run of KP (d², id) entries
  const long long out = (static_cast<long long>(split) * n_r + q0 + sel_q) * KR;
  for (int o = 0; o < KR; ++o) {
    float bd = rd[0];
    int bp = rp[0];
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (run_before(od, op, bd, bp)) {
        bd = od;
        bp = op;
      }
    }
    if (sel_c == 0 && sel_q < nq) {
      part_d[out + o] = bd;
      part_p[out + o] = bp;
    }
    if (rp[0] == bp) {  // ids are unique in the group; an empty winner pops empties only
#pragma unroll
      for (int j = 0; j + 1 < KR; ++j) {
        rd[j] = rd[j + 1];
        rp[j] = rp[j + 1];
      }
      rd[KR - 1] = CUDART_INF_F;
      rp[KR - 1] = -1;
    }
  }
}

// A warp per query folds the n_splits wide partial runs (rows of 2k, the
// first k the run) through a wide run in scratch (n_r x 2k) and writes
// (√d², id).
__global__ void __launch_bounds__(kThreads)
dense_topk_merge_wide(const float* __restrict__ part_d, const int* __restrict__ part_p,
                      float* __restrict__ scratch_d, int* __restrict__ scratch_p,
                      float* __restrict__ out_d, int* __restrict__ out_p, int n_r, int k,
                      int n_splits) {
  __shared__ float buf_d[kThreads / 32][kCap];
  __shared__ int buf_p[kThreads / 32][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  if (q >= n_r) return;  // warp-uniform
  WideRun<kCap> run;
  run.init(scratch_d + q * 2LL * k, scratch_p + q * 2LL * k, scratch_d + q * 2LL * k + k,
           scratch_p + q * 2LL * k + k, buf_d[warp], buf_p[warp], k);
  for (int sp = 0; sp < n_splits; ++sp) {
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

// A warp per query folds the n_splits partial runs into one and writes the
// first k entries as (√d², id).
template <int KP>
__global__ void __launch_bounds__(kThreads)
dense_topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_p,
                 float* __restrict__ out_d, int* __restrict__ out_p, int n_r, int k,
                 int n_splits) {
  const long long q = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (q >= n_r) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  float rd[KP];
  int rp[KP];
  run_init(rd, rp);
  const int n = n_splits * KP;
  for (int e = lane; e < n; e += 32) {
    const int sp = e / KP;
    const long long at = (static_cast<long long>(sp) * n_r + q) * KP + (e - sp * KP);
    const int p = part_p[at];
    if (p >= 0) run_insert(rd, rp, part_d[at], p);
  }
  warp_merge_flush(rd, rp, k, out_d + q * k, out_p + q * k);
}

template <int KP>
cudaError_t launch(const float* r, const float* s, const signed char* mask, float* part_d,
                   int* part_p, float* scratch_d, int* scratch_p, float* out_d, int* out_p,
                   int n_r, int n_s, int d, int k, int bm, int bn, int n_splits,
                   cudaStream_t stream) {
  const int nr_tiles = (n_r + bm - 1) / bm;
  const int sub_per_tile = (bm + kBQ - 1) / kBQ;
  const int ns_tiles = (n_s + bn - 1) / bn;
  const int tiles_per_split = (ns_tiles + n_splits - 1) / n_splits;
  const long long nr_blocks = static_cast<long long>(nr_tiles) * sub_per_tile;
  if (nr_blocks > 0x7fffffffLL || n_splits > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nr_blocks), n_splits);
  dense_topk_partial<KP><<<grid, kThreads, 0, stream>>>(r, s, mask, part_d, part_p, n_r, n_s, d,
                                                        k, bm, bn, ns_tiles, sub_per_tile,
                                                        tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned merge_blocks = static_cast<unsigned>((n_r + kThreads / 32 - 1) / (kThreads / 32));
  if constexpr (KP == 0)
    dense_topk_merge_wide<<<merge_blocks, kThreads, 0, stream>>>(
        part_d, part_p, scratch_d, scratch_p, out_d, out_p, n_r, k, n_splits);
  else
    dense_topk_merge<KP><<<merge_blocks, kThreads, 0, stream>>>(part_d, part_p, out_d, out_p,
                                                                 n_r, k, n_splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches both passes on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue for
// shapes it does not take: d, k, bm, bn, n_splits >= 1). `mask` may be null
// (every tile). k <= 64: part_d / part_p hold n_splits x n_r x KP entries,
// KP = max(8, next_pow2(k)), and scratch may be null; k > 64: part_d /
// part_p hold n_splits x n_r x 2k entries and scratch_d / scratch_p n_r x 2k.
extern "C" int repro_dense_topk(const void* r, const void* s, const void* mask, void* part_d,
                                void* part_p, void* scratch_d, void* scratch_p, void* out_d,
                                void* out_p, int n_r, int n_s, int d, int k, int bm, int bn,
                                int n_splits, void* stream) {
  if (d < 1 || k < 1 || bm < 1 || bn < 1 || n_r < 1 || n_s < 1 || n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* sf = static_cast<const float*>(s);
  const auto* mk = static_cast<const signed char*>(mask);
  auto* pd = static_cast<float*>(part_d);
  auto* pp = static_cast<int*>(part_p);
  auto* xd = static_cast<float*>(scratch_d);
  auto* xp = static_cast<int*>(scratch_p);
  auto* od = static_cast<float*>(out_d);
  auto* op = static_cast<int*>(out_p);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 8)
    err = launch<8>(rf, sf, mk, pd, pp, xd, xp, od, op, n_r, n_s, d, k, bm, bn, n_splits, st);
  else if (k <= 16)
    err = launch<16>(rf, sf, mk, pd, pp, xd, xp, od, op, n_r, n_s, d, k, bm, bn, n_splits, st);
  else if (k <= 32)
    err = launch<32>(rf, sf, mk, pd, pp, xd, xp, od, op, n_r, n_s, d, k, bm, bn, n_splits, st);
  else if (k <= 64)
    err = launch<64>(rf, sf, mk, pd, pp, xd, xp, od, op, n_r, n_s, d, k, bm, bn, n_splits, st);
  else if (xd == nullptr || xp == nullptr)
    err = cudaErrorInvalidValue;
  else
    err = launch<0>(rf, sf, mk, pd, pp, xd, xp, od, op, n_r, n_s, d, k, bm, bn, n_splits, st);
  return static_cast<int>(err);
}
