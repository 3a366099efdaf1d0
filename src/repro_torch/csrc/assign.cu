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
// The chain, which fixes the bits. ‖x‖², ‖p‖² and x·p are each one fmaf
// chain over ascending j (zero-padded columns leave a chain unchanged);
// d² = fmaxf((‖x‖² + ‖p‖²) − 2.f·x·p, 0.f), taken as one fmaf(−2, x·p,
// ‖x‖² + ‖p‖²) (2·x·p is exact, so the bits are the same and an
// instruction is saved); the distance is sqrtf(d²).
// Both forms and every split keep it, so they give the same ids and
// distances, and so does K-D at k = 1 (csrc/dense_topk.cu sums the same
// chains): the card tests hold all three bit for bit. fp32 FMAs on CUDA
// cores, no TF32 or tensor cores, and no split of the sum over d: each
// would move the bits.
//
// What bounds it on this card. n·M·(2d + 3) fp32 operations against
// 4·n·(d + 2) bytes: at d = 10, M = 256 that is ~120 flops a byte, far above
// the ≈ 20 at which an H100 SXM turns compute bound on CUDA cores (67
// TFLOP/s, 3.35 TB/s at 700 W). So instruction issue bounds it, not HBM:
// the narrow form issues about d + 7 instructions a (row, pivot) pair — d
// FMAs for x·p, the norms' add, the fmaf with −2, the clamp, the compare,
// two selects and a share of a pivot load (d + 5 where it scans 4 pivots at
// a time) — where the bound counts 2d + 3 operations at the FMA rate (at d =
// 10 the floor is 15 issues a pair, 0.067 ms for the Forest build at 1.98
// GHz, against a 0.051 ms bound); the tile
// form issues d FMAs a pair and one 16-byte load per 16 FMAs, an SGEMM's
// ratio.
//
// Two forms, chosen on the host from the static shapes alone
// (kernels/assign.py, plan_assign).
// - Narrow (d <= 32): rows in registers, pivots in shared memory. A block
//   of 8 warps stages its pivots once, columns zero-padded to a multiple of
//   4, and computes each ‖p‖² once, one thread a pivot. Each warp then walks
//   groups of 32·R consecutive rows (R = 4 up to d = 16, else 2): it stages
//   a group with 16-byte cp.async copies (where d % 4 == 0 into rows of an
//   odd multiple of 4 floats, so that each lane's 16-byte reads of its own
//   rows fall in distinct bank groups; else as the contiguous span, at most
//   2-way conflicts), and every lane holds R rows with their ‖x‖² in
//   registers. One 16-byte broadcast load of four pivot coordinates then
//   feeds 4·R FMAs (one load an FMA before). With 4 rows a lane the scan
//   takes 4 pivots at a time: a NaN-keeping min of their unclamped d²,
//   then one clamp, compare and select for the 4 (the pivot within a
//   winning 4 is found after the scan), 2 issues a pair fewer. The grid is
//   what the card holds resident, and the groups go round the warps of all
//   blocks, so the last round is spread over every SM rather than left to a
//   few blocks.
// - Tile (d > 32): an SGEMM-class fp32 tile with the argmin fused in. A
//   block owns 128 rows and walks 128 pivots at a time; 256 threads each
//   accumulate an 8 × 8 register micro-tile over 32-deep chunks of d that
//   a cp.async double buffer stages (rows padded to 36 floats: the eight
//   rows a quarter-warp reads in one 16-byte load fall in distinct bank
//   groups). ‖x‖² and ‖p‖² are summed from the same staged chunks. In the
//   epilogue of a pivot tile each thread keeps a running (d², id) minimum
//   per row over its 8 pivots; at the end the 16 threads of a row combine
//   theirs with shuffles, in (d², id) order. A row tile is read once per
//   128 pivots, not once per 32.
// Splits. Where the rows give too few blocks for 132 SMs (a seal of a few
// thousand rows, a quantized fallback batch), or a split's pivots would not
// fit shared memory, the pivots are cut into contiguous ranges, one per
// blockIdx.y. Each split writes each row's (d², id) minimum as a 64-bit key,
// (d² bits << 32) | id; d² >= 0, so its bits order as unsigned integers and
// the least key is the (d², id) the scan over all pivots picks. A folding
// pass takes it and writes (id, √d²). Every cut gives the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kNT = 256;                      // threads a block, both forms
constexpr int kPivBytes = 48 * 1024;          // narrow form: a split's pivots and norms
constexpr int kTR = 128;                      // rows a tile
constexpr int kTP = 128;                      // pivots a tile
constexpr int kBK = 32;                       // depth of a staged chunk of d
constexpr int kTS = kBK + 4;                  // row stride of a staged chunk (floats)
constexpr unsigned long long kNoKey = ~0ULL;  // no finite d²
constexpr int kMaxDevices = 64;
// how the narrow form stages a warp's rows
constexpr int kRowsPadded = 0;  // 16-byte copies into rows of an odd multiple of 4 floats
constexpr int kRowsSpan16 = 1;  // the span as it is, 16-byte copies
constexpr int kRowsSpan4 = 2;   // the span as it is, 4-byte copies (unaligned input)

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

// A row's result: (id, √d²) with one split; else the split's key (d² bits
// << 32) | id, or kNoKey where no pivot of the split gave a finite d², at
// part[split · n + row].
__device__ __forceinline__ void emit(long long row, float best, int arg, int* pid, float* dist,
                                     unsigned long long* part, int n) {
  if (part == nullptr) {
    pid[row] = arg;
    dist[row] = sqrtf(best);
  } else {
    part[static_cast<long long>(blockIdx.y) * n + row] =
        arg < 0 ? kNoKey
                : (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
                      static_cast<unsigned>(arg);
  }
}

// ---- the narrow form

// Stage pivots [p0, p0 + cnt) into ps (SD columns, zero past d) with 4-byte
// cp.async copies.
template <int SD>
__device__ __forceinline__ void stage_pivots(float* ps, const float* __restrict__ p, int p0,
                                             int cnt, int d) {
  for (int e = threadIdx.x; e < cnt * SD; e += kNT) {
    const int q = e / SD;
    const int j = e - q * SD;
    const bool ok = j < d;
    cp_async4(ps + e, ok ? p + static_cast<long long>(p0 + q) * d + j : p, ok ? 4 : 0);
  }
}

// A warp stages its group of rows (a contiguous span of nrows · d floats)
// into xs: padded (d % 4 == 0, 16-byte aligned rows: row r at r · xst, xst
// an odd multiple of 4, so the lanes' 16-byte reads of their rows fall in
// distinct bank groups) or as the span itself (16-byte copies where aligned,
// else 4-byte). Rows past nrows are not staged: their lanes hold zeros.
__device__ __forceinline__ void stage_rows(float* xs, const float* __restrict__ src, int nrows,
                                           int d, int xst, int mode, float inv_q4, int lane) {
  const int span = nrows * d;
  if (mode == kRowsPadded) {
    const int q4 = d / 4;
    for (int e = lane; e < nrows * q4; e += 32) {
      const int r = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_q4);
      const int c = 4 * (e - r * q4);
      cp_async16(xs + r * xst + c, src + r * d + c, 16);
    }
  } else if (mode == kRowsSpan16) {
    for (int e = lane * 4; e < span; e += 128) cp_async16(xs + e, src + e, min(4, span - e) * 4);
  } else {
    for (int e = lane; e < span; e += 32) cp_async4(xs + e, src + e, 4);
  }
}

// min that keeps a NaN (fminf drops it): a NaN t clamps to 0 in the chain,
// so it must reach the clamp.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// t = (‖x‖² + ‖p‖²) − 2·x·p, before the clamp at 0, of pivot q for each of
// a lane's R rows: x·p one fmaf chain over ascending j (the R rows' chains
// stepped together), then fmaf(−2, x·p, ‖x‖² + ‖p‖²).
template <int MAXD, int R, int SD>
__device__ __forceinline__ void pivot_t(const float (&xr)[R][MAXD], const float (&xn)[R],
                                        const float* ps, const float* pns, int q, float (&t)[R]) {
  float pv[SD];  // the pivot's first MAXD columns
#pragma unroll
  for (int j4 = 0; j4 < SD / 4; ++j4) {
    const float* at = ps + q * SD + 4 * j4;
    if (4 * j4 + 2 < MAXD) {
      const float4 v = *reinterpret_cast<const float4*>(at);
      pv[4 * j4] = v.x;
      pv[4 * j4 + 1] = v.y;
      pv[4 * j4 + 2] = v.z;
      pv[4 * j4 + 3] = v.w;
    } else {  // the last two of a width of 4k + 2
      const float2 v = *reinterpret_cast<const float2*>(at);
      pv[4 * j4] = v.x;
      pv[4 * j4 + 1] = v.y;
    }
  }
  const float pn = pns[q];
  float dot[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) dot[rr] = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j)
#pragma unroll
    for (int rr = 0; rr < R; ++rr) dot[rr] = fmaf(xr[rr][j], pv[j], dot[rr]);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) t[rr] = fmaf(-2.f, dot[rr], xn[rr] + pn);
}

// MAXD: the row width in registers (>= d; columns past d are zero on both
// sides); SD: MAXD rounded up to a multiple of 4, the pivots' stride in
// shared memory; R rows a lane. The block stages its split's pivots once;
// then each warp walks groups of 32·R rows (lane l holds rows l + 32·i),
// group g = warp · gridDim.x + blockIdx.x + k · (gridDim.x · warps), so
// every SM gets an even share and the last round is spread over them.
template <int MAXD, int R, int MINB>
__global__ void __launch_bounds__(kNT, MINB)
assign_narrow(const float* __restrict__ x, const float* __restrict__ p, int* __restrict__ pid,
              float* __restrict__ dist, unsigned long long* __restrict__ part, int n, int m,
              int d, int per, int groups, int xst, int mode, float inv_q4) {
  constexpr int SD = (MAXD + 3) & ~3;
  constexpr int kG = 32 * R;
  constexpr int kW = kNT / 32;
  constexpr int kC = R >= 4 ? 4 : 1;  // pivots a chunk of the scan
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p_lo = blockIdx.y * per;
  const int cnt = min(per, m - p_lo);
  float* ps = smem;                                        // cnt · SD
  float* pns = ps + per * SD;                              // their ‖p‖²
  float* xs = smem + ((per * (SD + 1) + 3) & ~3) + warp * kG * xst;  // the warp's rows

  stage_pivots<SD>(ps, p, p_lo, cnt, d);
  int g = warp * gridDim.x + blockIdx.x;
  const int g_step = gridDim.x * kW;
  auto stage = [&](int grp) {
    const long long row0 = static_cast<long long>(grp) * kG;
    stage_rows(xs, x + row0 * d, static_cast<int>(min(static_cast<long long>(kG), n - row0)), d,
               xst, mode, inv_q4, lane);
  };
  if (g < groups) stage(g);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int q = tid; q < cnt; q += kNT) {
    float pn = 0.f;
#pragma unroll
    for (int j = 0; j < SD; ++j) pn = fmaf(ps[q * SD + j], ps[q * SD + j], pn);
    pns[q] = pn;
  }
  __syncthreads();

  for (bool first = true; g < groups; g += g_step, first = false) {
    if (!first) {
      stage(g);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncwarp();  // the group's rows have landed, for every lane
    const long long row0 = static_cast<long long>(g) * kG;
    float xr[R][MAXD];
    float xn[R];
    float best[R];
    int arg[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int r = lane + 32 * rr;
      const bool act = row0 + r < n;
      if (mode == kRowsPadded) {
#pragma unroll
        for (int j4 = 0; j4 < SD / 4; ++j4) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (act && 4 * j4 < d) v = *reinterpret_cast<const float4*>(xs + r * xst + 4 * j4);
          const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * j4 + k < MAXD) xr[rr][4 * j4 + k] = e4[k];
        }
      } else {
#pragma unroll
        for (int j = 0; j < MAXD; ++j) xr[rr][j] = (act && j < d) ? xs[r * d + j] : 0.f;
      }
      xn[rr] = 0.f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j) xn[rr] = fmaf(xr[rr][j], xr[rr][j], xn[rr]);
      best[rr] = CUDART_INF_F;
      arg[rr] = -1;
    }
    __syncwarp();  // every lane has its rows: the next group may be staged
    // The scan, kC pivots at a time: the least t = (‖x‖² + ‖p‖²) − 2·x·p of
    // the kC (a NaN kept: the chain's fmaxf clamps it to 0), clamped once,
    // is their least d², and a strictly smaller one than the row's best so
    // far takes its place with arg = −2 − the chunk's first pivot; which
    // pivot of the chunk it was is found after the scan. The pivots past
    // the last whole chunk are compared one at a time.
    const int whole = cnt / kC * kC;
#pragma unroll (kC == 1 ? 4 : 1)
    for (int q0 = 0; q0 < whole; q0 += kC) {
      float cmin[R];
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        float t[R];
        pivot_t<MAXD, R, SD>(xr, xn, ps, pns, q0 + k, t);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) cmin[rr] = k == 0 ? t[rr] : fmin_nan(cmin[rr], t[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float d2 = fmaxf(cmin[rr], 0.f);
        if (d2 < best[rr]) {
          best[rr] = d2;
          arg[rr] = kC == 1 ? q0 : -2 - q0;
        }
      }
    }
    if (kC > 1) {
      for (int q = whole; q < cnt; ++q) {
        float t[R];
        pivot_t<MAXD, R, SD>(xr, xn, ps, pns, q, t);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float d2 = fmaxf(t[rr], 0.f);
          if (d2 < best[rr]) {
            best[rr] = d2;
            arg[rr] = q;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {  // a row won by a chunk: its first pivot at the least d²
        if (arg[rr] > -2) continue;
        const int q0 = -2 - arg[rr];
        for (int k = 0; k < kC; ++k) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < MAXD; ++j) dot = fmaf(xr[rr][j], ps[(q0 + k) * SD + j], dot);
          if (fmaxf(fmaf(-2.f, dot, xn[rr] + pns[q0 + k]), 0.f) == best[rr]) {
            arg[rr] = q0 + k;
            break;
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      if (arg[rr] >= 0) arg[rr] += p_lo;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const long long row = row0 + lane + 32 * rr;
      if (row < n) emit(row, best[rr], arg[rr], pid, dist, part, n);
    }
  }
}

// ---- the tile form

struct TileSmem {
  float a[2][kTR * kTS];  // a chunk of the block's rows
  float b[2][kTP * kTS];  // the same chunk of a pivot tile
  float xn[kTR];
  float pn[kTP];
};

// Stage chunk `chunk` (kBK columns of d) of the block's rows and of the
// pivot tile at pbase into buffer `buf` with cp.async (16-byte copies where
// vec), zero-filled past d and past the rows.
__device__ __forceinline__ void tile_stage(TileSmem& sm, const float* __restrict__ x,
                                           const float* __restrict__ p, long long row0, int nq,
                                           int pbase, int prows, int chunk, int d, int vec,
                                           int buf, int tid) {
  const int k0 = chunk * kBK;
  if (vec) {
    for (int e = tid; e < kTR * (kBK / 4); e += kNT) {
      const int rr = e >> 3;
      const int j = (e & 7) * 4;
      const bool xa = rr < nq && k0 + j < d;
      cp_async16(&sm.a[buf][rr * kTS + j], xa ? x + (row0 + rr) * d + k0 + j : x, xa ? 16 : 0);
      const bool pa = rr < prows && k0 + j < d;
      cp_async16(&sm.b[buf][rr * kTS + j],
                 pa ? p + static_cast<long long>(pbase + rr) * d + k0 + j : p, pa ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTR * kBK; e += kNT) {
      const int rr = e >> 5;
      const int j = e & 31;
      const bool xa = rr < nq && k0 + j < d;
      cp_async4(&sm.a[buf][rr * kTS + j], xa ? x + (row0 + rr) * d + k0 + j : x, xa ? 4 : 0);
      const bool pa = rr < prows && k0 + j < d;
      cp_async4(&sm.b[buf][rr * kTS + j],
                pa ? p + static_cast<long long>(pbase + rr) * d + k0 + j : p, pa ? 4 : 0);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kNT, 1)
assign_tile(const float* __restrict__ x, const float* __restrict__ p, int* __restrict__ pid,
            float* __restrict__ dist, unsigned long long* __restrict__ part, int n, int m, int d,
            int per, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTR;
  const int nq = static_cast<int>(min(static_cast<long long>(kTR), n - row0));
  const int p_lo = blockIdx.y * per;
  const int p_hi = min(m, p_lo + per);
  const int n_chunks = (d + kBK - 1) / kBK;
  // the micro-tile: rows ty + 16·i, pivots tx + 16·j of the pivot tile
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = CUDART_INF_F;
    arg[i] = -1;
  }
  float acc[8][8];
  // ‖p‖² of pivot row tid (threads < 128) and, over the first pivot tile,
  // ‖x‖² of row tid − 128 (threads >= 128): ascending fmaf chains
  float sn = 0.f;
  bool first_tile = true;
  int pbase = p_lo;
  int chunk = 0;
  int buf = 0;
  tile_stage(sm, x, p, row0, nq, pbase, min(kTP, p_hi - pbase), 0, d, vec, 0, tid);
  while (pbase < p_hi) {
    const int prows = min(kTP, p_hi - pbase);
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      if (tid < kTP) sn = 0.f;
    }
    // the item after this one: the next chunk of d, or the next pivot tile
    int nbase = pbase;
    int nchunk = chunk + 1;
    if (nchunk == n_chunks) {
      nbase += kTP;
      nchunk = 0;
    }
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the other buffer's reads are done
    if (nbase < p_hi)
      tile_stage(sm, x, p, row0, nq, nbase, min(kTP, p_hi - nbase), nchunk, d, vec, buf ^ 1,
                 tid);
    const float* as = sm.a[buf];
    const float* bs = sm.b[buf];
    if (tid < kTP || first_tile) {
      const float* nr = tid < kTP ? bs + tid * kTS : as + (tid - kTP) * kTS;
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
      // epilogue of the pivot tile: pivots come in ascending id within a
      // thread, so a strict < keeps the lowest id of a tie
      if (tid < kTP)
        sm.pn[tid] = sn;
      else if (first_tile)
        sm.xn[tid - kTP] = sn;
      first_tile = false;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xq = sm.xn[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          const float d2 = fmaxf(fmaf(-2.f, acc[i][j], xq + sm.pn[c]), 0.f);
          if (c < prows && d2 < best[i]) {
            best[i] = d2;
            arg[i] = pbase + c;
          }
        }
      }
      // the next tile's writes of pn come after its top barrier
    }
    buf ^= 1;
    pbase = nbase;
    chunk = nchunk;
  }
  // the 16 threads of a row (one half-warp) combine in (d², id) order; an
  // id of -1 (no finite d²) orders last
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float b = best[i];
    int a = arg[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const int oa = __shfl_xor_sync(0xffffffffu, a, off);
      if (ob < b || (ob == b && static_cast<unsigned>(oa) < static_cast<unsigned>(a))) {
        b = ob;
        a = oa;
      }
    }
    const int qi = ty + 16 * i;
    if (tx == 0 && qi < nq) emit(row0 + qi, b, a, pid, dist, part, n);
  }
}

// The splits' keys of each row folded: the least is the (d², id) the scan
// over all pivots picks; written as (id, √d²), or (-1, +inf) where no pivot
// gave a finite d².
__global__ void __launch_bounds__(kNT)
assign_fold(const unsigned long long* __restrict__ part, int* __restrict__ pid,
            float* __restrict__ dist, int n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kNT + threadIdx.x;
  if (i >= n) return;
  unsigned long long k = kNoKey;
  for (int s = 0; s < splits; ++s) k = min(k, part[static_cast<long long>(s) * n + i]);
  pid[i] = k == kNoKey ? -1 : static_cast<int>(static_cast<unsigned>(k));
  dist[i] = k == kNoKey ? CUDART_INF_F : sqrtf(__uint_as_float(static_cast<unsigned>(k >> 32)));
}

struct Args {
  const float* x;
  const float* p;
  int* pid;
  float* dist;
  unsigned long long* part;
  int n, m, d, splits, per;
  bool aligned;  // x 16-byte aligned
  cudaStream_t stream;
};

// Raise `kernel`'s shared-memory limit to `smem_max` once per device
// (`ready`: the caller's flags for this kernel).
template <typename K>
cudaError_t prepare(K kernel, size_t smem_max, bool* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_max));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// The blocks of `kernel` resident on the whole card at `smem` bytes each
// (`seen`: the caller's cache for this kernel, the last answer a device).
struct Resident {
  size_t smem;
  int blocks;
};
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, Resident* seen, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (seen[dev].blocks == 0 || seen[dev].smem != smem) {
    int sms = 0;
    int occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kNT, smem);
    if (err != cudaSuccess) return err;
    seen[dev] = Resident{smem, std::max(1, occ) * sms};
  }
  *blocks = seen[dev].blocks;
  return cudaSuccess;
}

// The narrow form's pivots a split: what kPivBytes holds at stride SD + 1.
constexpr int narrow_cap(int sd) { return kPivBytes / static_cast<int>(sizeof(float) * (sd + 1)); }

template <int MAXD, int R, int MINB>
cudaError_t launch_narrow(const Args& a) {
  constexpr int SD = (MAXD + 3) & ~3;
  constexpr int kG = 32 * R;
  if (a.per > narrow_cap(SD)) return cudaErrorInvalidValue;
  const int mode = !a.aligned ? kRowsSpan4 : a.d % 4 == 0 ? kRowsPadded : kRowsSpan16;
  // padded rows: a stride of an odd multiple of 4 floats
  const int xst = mode == kRowsPadded ? ((a.d / 4) % 2 == 1 ? a.d : a.d + 4) : a.d;
  const auto rows_bytes = [](int st) { return sizeof(float) * (kNT / 32) * kG * st; };
  const size_t piv = sizeof(float) * ((a.per * (SD + 1) + 3) & ~3);
  const size_t smem = piv + rows_bytes(xst);
  const size_t smem_max =
      sizeof(float) * ((narrow_cap(SD) * (SD + 1) + 3) & ~3) + rows_bytes(MAXD + 4);
  static bool ready[kMaxDevices];
  static Resident seen[kMaxDevices];
  int resident = 0;
  cudaError_t err = prepare(assign_narrow<MAXD, R, MINB>, smem_max, ready);
  if (err == cudaSuccess)
    err = resident_blocks(assign_narrow<MAXD, R, MINB>, smem, seen, &resident);
  if (err != cudaSuccess) return err;
  const int groups = (a.n + kG - 1) / kG;
  const int gx = std::max(1, std::min((groups + kNT / 32 - 1) / (kNT / 32), resident / a.splits));
  const float inv_q4 = a.d >= 4 ? 1.f / static_cast<float>(a.d / 4) : 0.f;
  assign_narrow<MAXD, R, MINB><<<dim3(gx, a.splits), kNT, smem, a.stream>>>(
      a.x, a.p, a.pid, a.dist, a.part, a.n, a.m, a.d, a.per, groups, xst, mode, inv_q4);
  return cudaGetLastError();
}

cudaError_t narrow_width(const Args& a) {
  if (a.d <= 4) return launch_narrow<4, 4, 3>(a);
  if (a.d <= 8) return launch_narrow<8, 4, 3>(a);
  if (a.d <= 10) return launch_narrow<10, 4, 3>(a);
  if (a.d <= 12) return launch_narrow<12, 4, 2>(a);
  if (a.d <= 16) return launch_narrow<16, 4, 2>(a);
  if (a.d <= 24) return launch_narrow<24, 2, 2>(a);
  return launch_narrow<32, 2, 2>(a);
}

cudaError_t launch_tile(const Args& a) {
  const size_t smem = sizeof(TileSmem);
  static bool ready[kMaxDevices];
  cudaError_t err = prepare(assign_tile, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.n + kTR - 1) / kTR), a.splits);
  const bool vec = a.d % 4 == 0 && a.aligned &&
                   reinterpret_cast<std::uintptr_t>(a.p) % 16 == 0;
  assign_tile<<<grid, kNT, smem, a.stream>>>(a.x, a.p, a.pid, a.dist, a.part, a.n, a.m, a.d,
                                             a.per, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for what it
// does not take). form 0 is the narrow form (d <= 32, at most
// narrow_cap(SD) pivots a split), form 1 the tile; the pivots are cut into
// `splits` ranges of `per` (split i: [i·per, (i+1)·per), none empty).
// With several splits `part` holds splits · n 64-bit keys that a folding
// pass reduces; with one it may be null.
extern "C" int repro_assign(const void* x, const void* pivots, void* pid, void* dist, void* part,
                            int n, int m, int d, int form, int splits, int per, void* stream) {
  if (n < 1 || m < 1 || d < 1 || splits < 1 || splits > 65535 || per < 1 ||
      static_cast<long long>(splits - 1) * per >= m || static_cast<long long>(splits) * per < m ||
      (form == 0 && d > 32) || form < 0 || form > 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x),
         static_cast<const float*>(pivots),
         static_cast<int*>(pid),
         static_cast<float*>(dist),
         splits > 1 ? static_cast<unsigned long long*>(part) : nullptr,
         n, m, d, splits, per,
         reinterpret_cast<std::uintptr_t>(x) % 16 == 0,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err = form == 0 ? narrow_width(a) : launch_tile(a);
  if (err != cudaSuccess || a.part == nullptr) return static_cast<int>(err);
  assign_fold<<<static_cast<unsigned>((n + kNT - 1) / kNT), kNT, 0, a.stream>>>(a.part, a.pid,
                                                                               a.dist, n, splits);
  return static_cast<int>(cudaGetLastError());
}
