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
// What bounds it on this card. Per (query, row) pair, d fp32 FMAs plus the
// norm, clamp and compare: 2d + 3 operations at 67 TFLOP/s, against 4d
// bytes per row read once. At the retrieval shapes (d = 10 with 4,096
// queries, d = 1,024 with 256) the operations bound it, not HBM — as long
// as a key is read by few blocks and a pair costs little beyond its FMAs.
//
// Two forms, chosen on the host from the static shapes alone
// (kernels/distance_topk.py, plan_dense). Both cut S into contiguous ranges
// of S tiles (splits) whose partial runs a merge pass folds
// per query in (d², id) order — a total order on unique ids, so every cut
// selects the same rows. Once a split's run of a query has filled, its last
// d² bounds the query's final k-th; the splits share the smallest such value
// through a per-query word in device memory (atomicMin) and skip every key
// past it, so the later splits' runs fill with little work. Any value read
// there is a valid bound, so the result does not depend on timing. A masked
// (R tile, S tile) is never loaded.
//
// - Narrow rows (d <= 32, k <= 64): a block owns 128 queries of one R tile,
//   one (k <= 16: two) per thread, each held in registers with ‖q‖² and its
//   own KP-run (csrc/sorted_run.cuh). The block streams its S range in
//   chunks of 128 rows through a double buffer of cp.async copies (16-byte
//   where rows allow, zero-padded to a multiple of 4 columns): the next
//   chunk is in flight while this one is scanned, and each staged row's ‖s‖²
//   is computed once, by one thread. Every lane then reads the same row (a
//   shared-memory broadcast, 16 bytes a load), does d FMAs and the norm sum
//   and clamp, and makes one compare against its run's tail. A row that
//   passes waits in a per-query column of shared memory; when any lane's
//   column fills, every lane folds its waiting rows into its run together
//   (the insertion network then runs on the whole warp, not on one lane at a
//   time). Each S row is read once per R tile, not once per 32 queries.
// - Wide rows (d > 32, and any run past k = 64): an SGEMM-class CUDA-core
//   tile with the selection fused in. A block owns 128 queries × 128 keys at
//   a time, 256 threads each accumulating an 8 × 8 fp32 register micro-tile
//   over 32-deep chunks of d that a cp.async double buffer stages (rows
//   padded to 36 floats: the eight rows a warp reads in one 16-byte load
//   fall in eight distinct bank groups). In the epilogue d² = (‖q‖² + ‖s‖²)
//   − 2·acc is clamped and compared with its query's current k-th (a
//   threshold in shared memory); a warp per query gathers what passed and,
//   for k <= 64, merges it at once (a few: one at a time) into the query's
//   run in shared memory (csrc/run_merge.cuh), so the threshold is exact
//   after every key tile and, once the runs fill, few queries have anything
//   to merge. Past k = 64 each query keeps a warp-wide run of k entries in
//   device memory (csrc/wide_run.cuh) fed through a buffer of 64 candidates
//   (up to k = 128 merged in the warp's shared scratch). The norms and
//   dot products are the narrow form's fmaf chains, so both forms report
//   the same bits. With 256 queries over 262,144 keys, 2 R tiles × 64
//   splits fill the card (one block an SM) and each key is read twice.
// - Precision. fp32 FMAs on CUDA cores in both forms, no TF32 and no tensor
//   cores: TF32 noise (or a 3×TF32 split) would change which near-ties
//   survive. Row offsets are 64-bit (n_s·d passes 2³¹ at 2.1 M keys of width
//   1,024).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "run_merge.cuh"
#include "sorted_run.cuh"
#include "wide_run.cuh"

namespace {

using repro_torch::run_init;
using repro_torch::run_insert;
using repro_torch::warp_merge_flush;
using repro_torch::WideRun;

constexpr int kQB = 128;      // queries per block, both forms
constexpr int kCH = 128;      // S rows per staged chunk of the narrow form
constexpr int kCB = 12;       // waiting candidates per query of the narrow form
constexpr int kTK = 128;      // keys per tile of the wide form
constexpr int kBK = 32;       // depth of one staged chunk of the wide form
constexpr int kTS = kBK + 4;  // row stride of a staged wide chunk (floats)
constexpr int kDS = kTK + 1;  // row stride of the wide form's d² tile
constexpr int kTileThreads = 256;
constexpr int kMergeThreads = 256;
constexpr int kCap = 64;      // candidate buffer of a wide run
constexpr int kFewInserts = 4;  // a tile's candidates of one query inserted one at a time

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }

// The next float up from a d² >= 0 (+inf stays): a key at or under a shared
// bound g beats it iff its d² < next_up(g).
__device__ __forceinline__ float next_up(float g) {
  return g < CUDART_INF_F ? __uint_as_float(__float_as_uint(g) + 1u) : g;
}

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

// The block's walk over its split of S: chunks of at most `step` rows of
// every S tile in [t, t_end) that the mask does not drop (block-uniform).
struct Walk {
  const signed char* mask;  // row of the block's R tile, or null
  long long n_s;
  int bn, t, t_end, c0, step;

  __device__ __forceinline__ void skip_masked() {
    while (t < t_end && mask != nullptr && mask[t] == 0) ++t;
  }
  __device__ __forceinline__ bool valid() const { return t < t_end; }
  __device__ __forceinline__ long long base() const { return static_cast<long long>(t) * bn + c0; }
  __device__ __forceinline__ int rows() const {
    const long long tile_end = lmin(n_s, static_cast<long long>(t) * bn + bn);
    return static_cast<int>(lmin(step, tile_end - base()));
  }
  __device__ __forceinline__ Walk next() const {
    Walk w = *this;
    w.c0 += step;
    if (w.c0 >= bn || w.base() >= n_s) {
      w.c0 = 0;
      ++w.t;
      w.skip_masked();
    }
    return w;
  }
};

__device__ __forceinline__ Walk make_walk(const signed char* mask, int tile_r, int ns_tiles,
                                          long long n_s, int bn, int split, int per, int step) {
  Walk w;
  w.mask = mask == nullptr ? nullptr : mask + static_cast<long long>(tile_r) * ns_tiles;
  w.n_s = n_s;
  w.bn = bn;
  w.t = split * per;
  w.t_end = static_cast<int>(lmin(ns_tiles, static_cast<long long>(w.t) + per));
  w.c0 = 0;
  w.step = step;
  w.skip_masked();
  return w;
}

// ---- the narrow form

// Every lane folds its waiting candidates into its runs at once, so the
// insertion network runs on all lanes together instead of one at a time.
// A full run's last d² bounds its query's final k-th: it is shared with the
// other splits through `bound` (d² >= 0, so its bits order as unsigned).
template <int KP, int QT>
__device__ __forceinline__ void narrow_flush(float (&rd)[QT][KP], int (&rp)[QT][KP],
                                             float (&tail)[QT], int (&cnt)[QT],
                                             const float (*cand_d)[kQB], const int (*cand_p)[kQB],
                                             unsigned* bound, const bool (&act)[QT], int tid) {
  constexpr int kT = kQB / QT;
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) {
    const int col = tid + qq * kT;
    for (int i = 0; i < cnt[qq]; ++i) run_insert(rd[qq], rp[qq], cand_d[i][col], cand_p[i][col]);
    if (cnt[qq] > 0 && act[qq] && rd[qq][KP - 1] < CUDART_INF_F)
      atomicMin(bound + col, __float_as_uint(rd[qq][KP - 1]));
    cnt[qq] = 0;
    tail[qq] = fminf(tail[qq], rd[qq][KP - 1]);
  }
}

// Stage a chunk of the walk into dst (SD columns a row, a multiple of 4,
// zero-filled past d and past the chunk's rows) with cp.async, 16-byte
// copies where d % 4 == 0.
template <int SD, int kT>
__device__ __forceinline__ void narrow_stage(float* dst, const float* __restrict__ s,
                                             long long base, int rows, int d, int vec, int tid) {
  if (vec) {
    constexpr int c4 = SD / 4;
    for (int e = tid; e < kCH * c4; e += kT) {
      const int rr = e / c4;
      const int j = (e - rr * c4) * 4;
      const bool ok = rr < rows && j < d;
      cp_async16(dst + rr * SD + j, ok ? s + (base + rr) * d + j : s, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kCH * SD; e += kT) {
      const int rr = e / SD;
      const int j = e - rr * SD;
      const bool ok = rr < rows && j < d;
      cp_async4(dst + e, ok ? s + (base + rr) * d + j : s, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// QT queries a thread (strided by the block's thread count), MAXD the query
// width in registers (>= d; the columns past d are zero on both sides, so the
// dot and norm chains equal their d-long ones), staged rows SD wide (MAXD
// rounded up to a multiple of 4, for 16-byte loads).
template <int KP, int MAXD, int QT>
__global__ void __launch_bounds__(kQB / QT)
dense_narrow(const float* __restrict__ r, const float* __restrict__ s,
             const signed char* __restrict__ mask, float* __restrict__ out_d,
             int* __restrict__ out_p, float* __restrict__ part_d, int* __restrict__ part_p,
             unsigned* __restrict__ bound, int n_r, int n_s, int d, int k, int bm, int bn,
             int ns_tiles, int qblocks, int per, int vec) {
  constexpr int kT = kQB / QT;
  constexpr int SD = (MAXD + 3) & ~3;
  __shared__ __align__(16) float rows_s[2][kCH * SD];
  __shared__ float norm_s[2][kCH];
  __shared__ float cand_d[kCB][kQB];  // candidates that beat a run's tail,
  __shared__ int cand_p[kCB][kQB];    // a column per query

  const int tile_r = blockIdx.x / qblocks;
  const int qb = blockIdx.x - tile_r * qblocks;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(tile_r) * bm + qb * kQB;
  if (qb * kQB >= bm || row0 >= n_r) return;  // block-uniform

  float q[QT][MAXD];
  float qn[QT];
  bool act[QT];
  long long row[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) {
    const int ql = qb * kQB + tid + qq * kT;
    row[qq] = static_cast<long long>(tile_r) * bm + ql;
    act[qq] = ql < bm && row[qq] < n_r;
    qn[qq] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXD; ++j) q[qq][j] = (act[qq] && j < d) ? r[row[qq] * d + j] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXD; ++j) qn[qq] = fmaf(q[qq][j], q[qq][j], qn[qq]);
  }
  float rd[QT][KP];
  int rp[QT][KP];
  float tail[QT];  // what a row must beat: the run's last d² when last
                   // flushed, or less where another split's run is tighter
  int cnt[QT];     // candidates waiting in the query's column
  unsigned* qbound = bound + row0;  // the block's queries' shared bounds
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) {
    run_init(rd[qq], rp[qq]);
    tail[qq] = CUDART_INF_F;
    cnt[qq] = 0;
  }
  Walk cur = make_walk(mask, tile_r, ns_tiles, n_s, bn, split, per, kCH);
  if (cur.valid()) narrow_stage<SD, kT>(rows_s[0], s, cur.base(), cur.rows(), d, vec, tid);
  for (int buf = 0; cur.valid(); buf ^= 1) {
    const Walk nxt = cur.next();
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the other buffer's scan is done
    if (nxt.valid()) narrow_stage<SD, kT>(rows_s[buf ^ 1], s, nxt.base(), nxt.rows(), d, vec, tid);
    const int rows = cur.rows();
    const float* rs = rows_s[buf];
    for (int rr = tid; rr < rows; rr += kT) {
      float sn = 0.f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j) sn = fmaf(rs[rr * SD + j], rs[rr * SD + j], sn);
      norm_s[buf][rr] = sn;
    }
    // another split's tighter run: a row at or past its last d² cannot
    // reach the final k (strictly past: ties go to the lower id)
#pragma unroll
    for (int qq = 0; qq < QT; ++qq)
      if (act[qq]) tail[qq] = fminf(tail[qq], next_up(__uint_as_float(__ldcg(qbound + tid + qq * kT))));
    __syncthreads();
    const int base = static_cast<int>(cur.base());
#pragma unroll 2
    for (int rr = 0; rr < rows; ++rr) {
      float sv[SD];
#pragma unroll
      for (int j4 = 0; j4 < SD / 4; ++j4) {
        const float4 v = *reinterpret_cast<const float4*>(rs + rr * SD + 4 * j4);
        sv[4 * j4] = v.x;
        sv[4 * j4 + 1] = v.y;
        sv[4 * j4 + 2] = v.z;
        sv[4 * j4 + 3] = v.w;
      }
      const float sn = norm_s[buf][rr];
      bool full = false;
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) dot = fmaf(q[qq][j], sv[j], dot);
        const float d2 = fmaxf((qn[qq] + sn) - 2.f * dot, 0.f);
        // rows come in ascending id, past every id in the run: (d2, id)
        // beats the tail iff d2 < its d² (+inf and NaN never enter)
        if (d2 < tail[qq]) {
          cand_d[cnt[qq]][tid + qq * kT] = d2;
          cand_p[cnt[qq]][tid + qq * kT] = base + rr;
          ++cnt[qq];
        }
        full = full || cnt[qq] == kCB;
      }
      if (__any_sync(0xffffffffu, full))
        narrow_flush(rd, rp, tail, cnt, cand_d, cand_p, qbound, act, tid);
    }
    cur = nxt;
  }
  narrow_flush(rd, rp, tail, cnt, cand_d, cand_p, qbound, act, tid);

  // one thread owns each query's whole run: write it out, or as the split's
  // partial run of KP (d², id) entries
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) {
    if (!act[qq]) continue;
    if (part_d == nullptr) {
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (j < k) {
          out_d[row[qq] * k + j] = rp[qq][j] < 0 ? CUDART_INF_F : sqrtf(rd[qq][j]);
          out_p[row[qq] * k + j] = rp[qq][j];
        }
      }
    } else {
      const long long at = (static_cast<long long>(split) * n_r + row[qq]) * KP;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        part_d[at + j] = rd[qq][j];
        part_p[at + j] = rp[qq][j];
      }
    }
  }
}

// A warp per query folds the splits' partial runs of KP entries into one and
// writes the first k as (√d², id).
template <int KP>
__global__ void __launch_bounds__(kMergeThreads)
dense_merge(const float* __restrict__ part_d, const int* __restrict__ part_p,
            float* __restrict__ out_d, int* __restrict__ out_p, int n_r, int k, int n_splits) {
  const long long q =
      static_cast<long long>(blockIdx.x) * (kMergeThreads / 32) + (threadIdx.x >> 5);
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

// ---- the wide form

struct TileSmem {
  float a[2][kQB * kTS];   // query chunk: 128 rows x 32 columns
  float b[2][kTK * kTS];   // key chunk
  float dt[kQB * kDS];     // the tile's d² (+inf where it cannot enter)
  float qn[kQB];
  float sn[kTK];
  float thr[kQB];          // each query's run tail (d²): its k-th, or a bound on it
  float gb[kQB];           // the bound on its final k-th the splits share
  int tail_p[kQB];
  int cur[kQB];            // wide runs: which of the two buffers holds the run
  int nb[kQB];             // wide runs: candidates waiting in the query's buffer
  float rl[kQB * kCap];    // k <= 64: each query's run (k entries a row of kCap);
  int rpos[kQB * kCap];    // k > 64: its wide run's candidate buffer
  float sc_d[kTileThreads / 32][kTK];  // a warp's candidates of one query
  int sc_p[kTileThreads / 32][kTK];
};

// Fold query qi's waiting candidates into its wide run (two buffers of k in
// part_d / part_p at `at`); its state lives in shared memory.
__device__ __noinline__ void tile_flush(TileSmem* sm, float* part_d, int* part_p, long long at,
                                        int qi, int k, unsigned* bound) {
  const int lane = threadIdx.x & 31;
  if (k <= kTK) {  // stage the run in the warp's scratch, merge there, write it back
    float* sd = sm->sc_d[threadIdx.x >> 5];
    int* sp = sm->sc_p[threadIdx.x >> 5];
    const long long src = at + sm->cur[qi] * static_cast<long long>(k);
    for (int j = lane; j < k; j += 32) {
      sd[j] = part_d[src + j];
      sp[j] = part_p[src + j];
    }
    __syncwarp();
    repro_torch::merge_into_run(sd, sp, k, sm->rl + qi * kCap, sm->rpos + qi * kCap, sm->nb[qi],
                                lane);
    for (int j = lane; j < k; j += 32) {
      part_d[src + j] = sd[j];
      part_p[src + j] = sp[j];
    }
    __syncwarp();
    if (lane == 0) {
      sm->nb[qi] = 0;
      sm->thr[qi] = sd[k - 1];
      sm->tail_p[qi] = sp[k - 1];
      if (sd[k - 1] < CUDART_INF_F) atomicMin(bound, __float_as_uint(sd[k - 1]));
    }
    __syncwarp();
    return;
  }
  WideRun<kCap> run;
  run.rd[0] = part_d + at;
  run.rp[0] = part_p + at;
  run.rd[1] = part_d + at + k;
  run.rp[1] = part_p + at + k;
  run.bd = sm->rl + qi * kCap;
  run.bp = sm->rpos + qi * kCap;
  run.k = k;
  run.cur = sm->cur[qi];
  run.nb = sm->nb[qi];
  run.tail_d = sm->thr[qi];
  run.tail_p = sm->tail_p[qi];
  run.flush();
  __syncwarp();
  if (lane == 0) {
    sm->cur[qi] = run.cur;
    sm->nb[qi] = 0;
    sm->thr[qi] = run.tail_d;
    sm->tail_p[qi] = run.tail_p;
    if (run.tail_d < CUDART_INF_F) atomicMin(bound, __float_as_uint(run.tail_d));
  }
  __syncwarp();
}

// Stage chunk `chunk` (kBK columns of d) of the block's queries and of a
// key tile into buffer `buf` with cp.async (16-byte copies where d % 4 ==
// 0), zero-filled past d and past the rows.
__device__ __forceinline__ void tile_stage(TileSmem& sm, const float* __restrict__ r,
                                           const float* __restrict__ s, long long row0, int nq,
                                           long long kbase, int krows, int chunk, int d, int vec,
                                           int buf, int tid) {
  const int k0 = chunk * kBK;
  if (vec) {
    for (int e = tid; e < kQB * (kBK / 4); e += kTileThreads) {
      const int rr = e >> 3;
      const int j = (e & 7) * 4;
      const bool qa = rr < nq && k0 + j < d;
      cp_async16(&sm.a[buf][rr * kTS + j], qa ? r + (row0 + rr) * d + k0 + j : r, qa ? 16 : 0);
      const bool ka = rr < krows && k0 + j < d;
      cp_async16(&sm.b[buf][rr * kTS + j], ka ? s + (kbase + rr) * d + k0 + j : s, ka ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kQB * kBK; e += kTileThreads) {
      const int rr = e >> 5;
      const int j = e & 31;
      const bool qa = rr < nq && k0 + j < d;
      cp_async4(&sm.a[buf][rr * kTS + j], qa ? r + (row0 + rr) * d + k0 + j : r, qa ? 4 : 0);
      const bool ka = rr < krows && k0 + j < d;
      cp_async4(&sm.b[buf][rr * kTS + j], ka ? s + (kbase + rr) * d + k0 + j : s, ka ? 4 : 0);
    }
  }
  cp_async_commit();
}

// WIDE (k > 64): each query's run is a wide run of k entries in part_d /
// part_p (two buffers per (split, query row); the first holds the split's
// run when the kernel ends), fed through a candidate buffer in shared
// memory; else the run sits in shared memory and each key tile's
// candidates merge into it at once, and the split's run is written as a
// partial run of kp entries (or, with one split, as (√d², id)).
template <bool WIDE>
__global__ void __launch_bounds__(kTileThreads, 1)
dense_tile(const float* __restrict__ r, const float* __restrict__ s,
           const signed char* __restrict__ mask, float* __restrict__ out_d,
           int* __restrict__ out_p, float* __restrict__ part_d, int* __restrict__ part_p,
           unsigned* __restrict__ bound, int n_r, int n_s, int d, int k, int kp, int bm, int bn,
           int ns_tiles, int qblocks, int per, int splits, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_raw);

  const int tile_r = blockIdx.x / qblocks;
  const int qb = blockIdx.x - tile_r * qblocks;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ql0 = qb * kQB;
  const long long row0 = static_cast<long long>(tile_r) * bm + ql0;
  if (ql0 >= bm || row0 >= n_r) return;  // block-uniform
  const int nq = static_cast<int>(lmin(lmin(kQB, bm - ql0), n_r - row0));
  auto wide_at = [=](int qi) {
    return (static_cast<long long>(split) * n_r + row0 + qi) * 2LL * k;
  };

  for (int i = tid; i < kQB; i += kTileThreads) {
    sm.thr[i] = CUDART_INF_F;
    sm.gb[i] = CUDART_INF_F;
    sm.tail_p[i] = -1;
    sm.cur[i] = 0;
    sm.nb[i] = 0;
  }
  if (WIDE) {
    for (int i = warp; i < nq; i += kTileThreads / 32) {
      for (int j = lane; j < k; j += 32) {
        part_d[wide_at(i) + j] = CUDART_INF_F;
        part_p[wide_at(i) + j] = -1;
      }
    }
  } else {
    for (int e = tid; e < kQB * kCap; e += kTileThreads) {
      sm.rl[e] = CUDART_INF_F;
      sm.rpos[e] = -1;
    }
  }

  // the micro-tile: queries ty + 16·i, keys tx + 16·j
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_chunks = (d + kBK - 1) / kBK;

  Walk cur = make_walk(mask, tile_r, ns_tiles, n_s, bn, split, per, kTK);
  int chunk = 0;
  if (cur.valid()) tile_stage(sm, r, s, row0, nq, cur.base(), cur.rows(), 0, d, vec, 0, tid);
  int buf = 0;
  float acc[8][8];
  // ‖s‖² of key row tid (threads < 128) and, over the first key tile, ‖q‖²
  // of query row tid − 128 (threads >= 128): ascending fmaf chains, as the
  // narrow form's, so both forms give the same d² bits
  float sn = 0.f;
  bool first_tile = true;
  while (cur.valid()) {
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      if (tid < kTK) sn = 0.f;
    }
    // the item after this one: the next chunk of d, or the next key tile
    Walk nw = cur;
    int nchunk = chunk + 1;
    if (nchunk == n_chunks) {
      nw = cur.next();
      nchunk = 0;
    }
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the other buffer's reads are done
    if (nw.valid()) tile_stage(sm, r, s, row0, nq, nw.base(), nw.rows(), nchunk, d, vec, buf ^ 1, tid);
    const float* as = sm.a[buf];
    const float* bs = sm.b[buf];
    if (tid < kTK || first_tile) {
      const float* nr = tid < kTK ? bs + tid * kTS : as + (tid - kTK) * kTS;
#pragma unroll
      for (int j4 = 0; j4 < kBK / 4; ++j4) {
        const float4 v = *reinterpret_cast<const float4*>(nr + 4 * j4);
        sn = fmaf(v.x, v.x, sn);
        sn = fmaf(v.y, v.y, sn);
        sn = fmaf(v.z, v.z, sn);
        sn = fmaf(v.w, v.w, sn);
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kTS + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kTS + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
      }
    }
    if (chunk + 1 == n_chunks) {
      // epilogue of the key tile: d² against each query's threshold. Keys
      // come in ascending id, past every id in the runs, so (d², id) beats a
      // run's tail iff d² < its d² (+inf and NaN never enter).
      const int krows = cur.rows();
      const int kbase = static_cast<int>(cur.base());
      if (tid < kTK)
        sm.sn[tid] = sn;
      else if (first_tile)
        sm.qn[tid - kTK] = sn;
      first_tile = false;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qi = ty + 16 * i;
        const float qn = sm.qn[qi];
        // past the run's k-th, or at or past another split's (ties go to
        // the lower id), a key cannot reach the final k
        const float th = fminf(sm.thr[qi], next_up(sm.gb[qi]));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          const float d2 = fmaxf((qn + sm.sn[c]) - 2.f * acc[i][j], 0.f);
          sm.dt[qi * kDS + c] = (qi < nq && c < krows && d2 < th) ? d2 : CUDART_INF_F;
        }
      }
      __syncthreads();
      // a warp per query: the candidates that passed, 32 columns at a time
      for (int qi = warp; qi < nq; qi += kTileThreads / 32) {
        if (lane == 0) sm.gb[qi] = __uint_as_float(__ldcg(bound + row0 + qi));
        float v[kTK / 32];
        unsigned hm[kTK / 32];
        int n = 0;
#pragma unroll
        for (int m = 0; m < kTK / 32; ++m) {
          v[m] = sm.dt[qi * kDS + lane + 32 * m];
          hm[m] = __ballot_sync(0xffffffffu, v[m] != CUDART_INF_F);
          n += __popc(hm[m]);
        }
        if (n == 0) continue;  // warp-uniform: the common case
        const unsigned lt = (1u << lane) - 1u;
        if (!WIDE) {
          int at = 0;
#pragma unroll
          for (int m = 0; m < kTK / 32; ++m) {
            if (hm[m] & (1u << lane)) {
              sm.sc_d[warp][at + __popc(hm[m] & lt)] = v[m];
              sm.sc_p[warp][at + __popc(hm[m] & lt)] = kbase + lane + 32 * m;
            }
            at += __popc(hm[m]);
          }
          __syncwarp();
          if (n <= kFewInserts) {  // a filled run: one at a time
            for (int c = 0; c < n; ++c)
              repro_torch::insert_into_run(sm.rl + qi * kCap, sm.rpos + qi * kCap, k,
                                           sm.sc_d[warp][c], sm.sc_p[warp][c], lane);
          } else {
            repro_torch::merge_into_run(sm.rl + qi * kCap, sm.rpos + qi * kCap, k, sm.sc_d[warp],
                                        sm.sc_p[warp], n, lane);
          }
          if (lane == 0) {
            const float kth = sm.rl[qi * kCap + k - 1];
            sm.thr[qi] = kth;
            if (kth < CUDART_INF_F) atomicMin(bound + row0 + qi, __float_as_uint(kth));
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int m = 0; m < kTK / 32; ++m) {
            unsigned h = hm[m];
            if (h == 0u) continue;
            int nb = sm.nb[qi];
            if (nb + __popc(h) > kCap) {  // the buffer is full: fold it in
              tile_flush(&sm, part_d, part_p, wide_at(qi), qi, k, bound + row0 + qi);
              nb = 0;
              h = __ballot_sync(0xffffffffu, v[m] < sm.thr[qi]);
            }
            if (h & (1u << lane)) {
              sm.rl[qi * kCap + nb + __popc(h & lt)] = v[m];
              sm.rpos[qi * kCap + nb + __popc(h & lt)] = kbase + lane + 32 * m;
            }
            __syncwarp();
            if (lane == 0) sm.nb[qi] = nb + __popc(h);
            __syncwarp();
          }
        }
      }
      // the next key tile's first reads of thr / dt come after the next
      // item's top barrier
    }
    buf ^= 1;
    cur = nw;
    chunk = nchunk;
  }
  __syncthreads();

  for (int qi = warp; qi < nq; qi += kTileThreads / 32) {
    const long long row = row0 + qi;
    if (WIDE) {
      const long long at = wide_at(qi);
      if (sm.nb[qi] > 0) tile_flush(&sm, part_d, part_p, at, qi, k, bound + row);
      const int c = sm.cur[qi];
      if (splits == 1) {
        const float* kd = part_d + at + c * k;
        const int* kpos = part_p + at + c * k;
        for (int j = lane; j < k; j += 32) {
          const int p = kpos[j];
          out_d[row * k + j] = p < 0 ? CUDART_INF_F : sqrtf(kd[j]);
          out_p[row * k + j] = p;
        }
      } else if (c == 1) {  // the run ends in the second buffer: move it to the first
        for (int j = lane; j < k; j += 32) {
          part_d[at + j] = part_d[at + k + j];
          part_p[at + j] = part_p[at + k + j];
        }
      }
    } else if (splits == 1) {
      for (int j = lane; j < k; j += 32) {
        const int p = sm.rpos[qi * kCap + j];
        out_d[row * k + j] = p < 0 ? CUDART_INF_F : sqrtf(sm.rl[qi * kCap + j]);
        out_p[row * k + j] = p;
      }
    } else {
      const long long at = (static_cast<long long>(split) * n_r + row) * kp;
      for (int j = lane; j < kp; j += 32) {
        part_d[at + j] = j < k ? sm.rl[qi * kCap + j] : CUDART_INF_F;
        part_p[at + j] = j < k ? sm.rpos[qi * kCap + j] : -1;
      }
    }
  }
}

// A warp per query folds the n_splits wide partial runs (rows of 2k, the
// first k the run) through a wide run in scratch (n_r x 2k) and writes
// (√d², id).
__global__ void __launch_bounds__(kMergeThreads)
dense_merge_wide(const float* __restrict__ part_d, const int* __restrict__ part_p,
                 float* __restrict__ scratch_d, int* __restrict__ scratch_p,
                 float* __restrict__ out_d, int* __restrict__ out_p, int n_r, int k,
                 int n_splits) {
  __shared__ float buf_d[kMergeThreads / 32][kCap];
  __shared__ int buf_p[kMergeThreads / 32][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * (kMergeThreads / 32) + warp;
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

struct Args {
  const float* r;
  const float* s;
  const signed char* mask;
  float* part_d;
  int* part_p;
  float* scratch_d;
  int* scratch_p;
  float* out_d;
  int* out_p;
  unsigned* bound;
  int n_r, n_s, d, k, bm, bn, splits, per;
  cudaStream_t stream;
};

template <int KP, int MAXD>
cudaError_t launch_narrow(const Args& a, dim3 grid, int ns_tiles, int qblocks) {
  constexpr int QT = KP <= 16 ? 2 : 1;
  const bool merged = a.splits > 1;
  const int vec = a.d % 4 == 0;
  dense_narrow<KP, MAXD, QT><<<grid, kQB / QT, 0, a.stream>>>(
      a.r, a.s, a.mask, a.out_d, a.out_p, merged ? a.part_d : nullptr,
      merged ? a.part_p : nullptr, a.bound, a.n_r, a.n_s, a.d, a.k, a.bm, a.bn, ns_tiles, qblocks,
      a.per, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merged) return err;
  const unsigned mb = static_cast<unsigned>((a.n_r + kMergeThreads / 32 - 1) / (kMergeThreads / 32));
  dense_merge<KP><<<mb, kMergeThreads, 0, a.stream>>>(a.part_d, a.part_p, a.out_d, a.out_p, a.n_r,
                                                      a.k, a.splits);
  return cudaGetLastError();
}

template <int KP>
cudaError_t narrow_width(const Args& a, dim3 grid, int ns_tiles, int qblocks) {
  if (a.d <= 4) return launch_narrow<KP, 4>(a, grid, ns_tiles, qblocks);
  if (a.d <= 8) return launch_narrow<KP, 8>(a, grid, ns_tiles, qblocks);
  if (a.d <= 10) return launch_narrow<KP, 10>(a, grid, ns_tiles, qblocks);
  if (a.d <= 12) return launch_narrow<KP, 12>(a, grid, ns_tiles, qblocks);
  if (a.d <= 16) return launch_narrow<KP, 16>(a, grid, ns_tiles, qblocks);
  if (a.d <= 24) return launch_narrow<KP, 24>(a, grid, ns_tiles, qblocks);
  return launch_narrow<KP, 32>(a, grid, ns_tiles, qblocks);
}

template <bool WIDE>
cudaError_t tile_kernel(const Args& a, dim3 grid, int ns_tiles, int qblocks, int kp) {
  const size_t smem = sizeof(TileSmem);
  cudaError_t err = cudaFuncSetAttribute(dense_tile<WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dense_tile<WIDE><<<grid, kTileThreads, smem, a.stream>>>(
      a.r, a.s, a.mask, a.out_d, a.out_p, a.part_d, a.part_p, a.bound, a.n_r, a.n_s, a.d, a.k, kp,
      a.bm, a.bn, ns_tiles, qblocks, a.per, a.splits, a.d % 4 == 0);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_tile(const Args& a, dim3 grid, int ns_tiles, int qblocks) {
  cudaError_t err = tile_kernel<false>(a, grid, ns_tiles, qblocks, KP);
  if (err != cudaSuccess || a.splits == 1) return err;
  const unsigned mb = static_cast<unsigned>((a.n_r + kMergeThreads / 32 - 1) / (kMergeThreads / 32));
  dense_merge<KP><<<mb, kMergeThreads, 0, a.stream>>>(a.part_d, a.part_p, a.out_d, a.out_p, a.n_r,
                                                      a.k, a.splits);
  return cudaGetLastError();
}

cudaError_t launch_tile_wide(const Args& a, dim3 grid, int ns_tiles, int qblocks) {
  if (a.scratch_d == nullptr && a.splits > 1) return cudaErrorInvalidValue;
  cudaError_t err = tile_kernel<true>(a, grid, ns_tiles, qblocks, 2 * a.k);
  if (err != cudaSuccess || a.splits == 1) return err;
  const unsigned mb = static_cast<unsigned>((a.n_r + kMergeThreads / 32 - 1) / (kMergeThreads / 32));
  dense_merge_wide<<<mb, kMergeThreads, 0, a.stream>>>(a.part_d, a.part_p, a.scratch_d,
                                                       a.scratch_p, a.out_d, a.out_p, a.n_r, a.k,
                                                       a.splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches the chosen form and, with
// several splits, the merge pass on `stream`; allocates nothing; returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
// form 0 (narrow: d <= 32, k <= 64) and form 1 (tile) with k <= 64:
// part_d / part_p hold splits x n_r x KP entries (KP = max(8,
// next_pow2(k))) and may be null with one split. Form 1 with k > 64 (wide
// runs): part_d / part_p hold splits x n_r x 2k entries, and with several
// splits scratch_d / scratch_p n_r x 2k. The splits cut the S tiles into
// ranges of `per` tiles (split i: tiles [i·per, (i+1)·per)). `bound` (n_r
// floats, +inf on entry) is where the splits share each query's smallest
// full-run tail.
extern "C" int repro_dense_topk(const void* r, const void* s, const void* mask, void* part_d,
                                void* part_p, void* scratch_d, void* scratch_p, void* out_d,
                                void* out_p, void* bound, int n_r, int n_s, int d, int k, int bm,
                                int bn, int form, int splits, int per, void* stream) {
  if (d < 1 || k < 1 || bm < 1 || bn < 1 || n_r < 1 || n_s < 1 || splits < 1 || per < 1 ||
      splits > 65535 || bound == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(r),   static_cast<const float*>(s),
         static_cast<const signed char*>(mask), static_cast<float*>(part_d),
         static_cast<int*>(part_p),      static_cast<float*>(scratch_d),
         static_cast<int*>(scratch_p),   static_cast<float*>(out_d),
         static_cast<int*>(out_p),       static_cast<unsigned*>(bound),
         n_r, n_s, d, k, bm, bn, splits, per,
         static_cast<cudaStream_t>(stream)};
  const int nr_tiles = (n_r + bm - 1) / bm;
  const int ns_tiles = (n_s + bn - 1) / bn;
  const int qblocks = (bm + kQB - 1) / kQB;
  const long long nr_blocks = static_cast<long long>(nr_tiles) * qblocks;
  if (nr_blocks > 0x7fffffffLL || static_cast<long long>(splits - 1) * per >= ns_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nr_blocks), splits);
  if ((splits > 1 || (form == 1 && k > 64)) && (a.part_d == nullptr || a.part_p == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (form == 1 && k > 64)
    err = launch_tile_wide(a, grid, ns_tiles, qblocks);
  else if (form == 1 && k <= 8)
    err = launch_tile<8>(a, grid, ns_tiles, qblocks);
  else if (form == 1 && k <= 16)
    err = launch_tile<16>(a, grid, ns_tiles, qblocks);
  else if (form == 1 && k <= 32)
    err = launch_tile<32>(a, grid, ns_tiles, qblocks);
  else if (form == 1)
    err = launch_tile<64>(a, grid, ns_tiles, qblocks);
  else if (form != 0 || d > 32 || k > 64)
    err = cudaErrorInvalidValue;
  else if (k <= 8)
    err = narrow_width<8>(a, grid, ns_tiles, qblocks);
  else if (k <= 16)
    err = narrow_width<16>(a, grid, ns_tiles, qblocks);
  else if (k <= 32)
    err = narrow_width<32>(a, grid, ns_tiles, qblocks);
  else
    err = narrow_width<64>(a, grid, ns_tiles, qblocks);
  return static_cast<int>(err);
}
