// Int8 coarse scan of the quantized tier for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel quant_coarse_gather_kernel
// (src/repro/kernels/quant_topk.py:105), wrapper quant_coarse_gather_pallas
// (:154, pallas_call at :230).
//
// What it computes. For every query row of R tile i and every row s of the
// S tiles that schedule[i, 0:counts[i]] names, the certified lower bound of
// coarse_lb_tile (quant_topk.py:50), in its order of float32 operations:
//   c   = Σ qcode·scode (int32, exact)        a, b = Σ qcode², Σ scode²
//   q2  = (qscale·qscale)·a                   s2 = (sscale·sscale)·b
//   d2  = (q2 + s2) − (2·(qscale·sscale))·c    dc = √max(d2, 0)
//   δ   = 2e-6·(q2 + s2)                       ε_num = δ / max(dc, √δ)
//   ε_t = ((ε_s + ε_q) + ε_num) + 1e-7         lb = max(dc − ε_t, 0)
// Every operation rounds on its own (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn: nothing contracts into an FMA), √ and / are the correctly
// rounded ones (never build with --use_fast_math), and a NaN lb stays NaN as
// in the plain version. So the kernel's lb is bit-equal to its plain torch
// version's. Rows with alive ≤ 0 and rows with lb > θ are dropped; the rest
// compete for an ascending run of the mp smallest (lb, position) pairs,
// ties to the lower position. Empty slots are (+inf, -1).
//
// What bounds it on this card. Per (query, row) pair: a d-long int8 dot and
// a few float32 operations, against d code bytes per visited row read once
// per R tile. So the int8 and fp32 issue rates bound it, not HBM — provided a
// staged row is shared by many queries and a pair costs little beyond its
// dot.
//
// The design.
// - A block owns half an R tile of 128 queries (64; 32 or 16 where runs of
//   256 or 512 entries would not fit shared memory, or a small R tile whole):
//   16 warps, each serving 1–4 queries, share every staged row. The block
//   walks one contiguous range of the tile's schedule (a split); the split
//   count comes from static shapes (kernels/quant_topk.py, plan_quant), and a
//   merge pass folds the splits' partial runs per query in (lb, position)
//   order — a total order on unique positions, so every cut gives the
//   unsplit bits. Once a split's run of a query has filled, its tail bounds
//   the query's final mp-th lb; the splits share the smallest such tail
//   through a per-query word in device memory (atomicMin) and cut with it
//   too, so later splits skip what an earlier one has already beaten. Any
//   value read there is a valid bound, so the bits do not depend on timing.
// - Staging. A visited tile's contiguous int8 codes (rows × d bytes), f16 ε_s
//   and alive are copied in chunks of up to 16 KB of codes with
//   cp.async.bulk (the TMA's 1-D bulk copy) onto an mbarrier, double-buffered:
//   the next chunk is in flight while this one is scanned. Once per chunk the
//   block repacks the rows into 4-byte words (zero-padded to a multiple of 4
//   words, of 8 past d = 32) and computes each row's Σcode², s2 and liveness, and the chunk's
//   largest live ε_s and s2 — a cost shared by all the block's queries.
// - The integer dot stays exact. Up to d = 32 it is __dp4a over packed words,
//   a lane's row held in registers while its warp's queries stream past it
//   from shared memory (broadcast loads). Past d = 32 it runs on the tensor
//   cores: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, 32 rows × the
//   warp's queries (8 columns, zero past the queries) a step of 32 codes, an
//   exact int32 sum. Either way the sum is exact in any order, so the bits
//   cannot move. The packed rows are padded to a stride of 4 mod 8 words, so
//   the words 32 lanes load at once fall in distinct banks.
// - A sound screen before the √ chain. Per query the cut is min(θ, the run's
//   tail lb, the bound the splits share): a pair with lb > cut can never
//   enter the final run (it fails the θ test, or mp pairs beat it). Per (query, chunk), and again whenever the cut changes,
//   the kernel computes with directed rounding
//     δ⁺   = RU(2e-6 · RU(q2 + s2max))        (s2max: the chunk's largest live s2)
//     ε⁺   = RU(RU(√δ⁺) · (1 + 2⁻²²))
//     εt⁺  = RU(RU(RU(εs_max + qe) + ε⁺) + 1e-7)   (εs_max: largest live ε_s)
//     D    = RU(succ(cut) + εt⁺)
//     T    = D > 0 ? RU(D · D) : −inf
//   and drops a pair iff d2 > T, with d2 the chain's own (three rounded ops).
//   Why d2 > T implies lb > cut: s2 ≤ s2max, so δ = RN(2e-6·RN(q2 + s2)) ≤
//   δ⁺ (RN ≤ RU, all monotone). ε_num = RN(δ / max(dc, RN√δ)) ≤
//   RN(δ / RN√δ), and RN√δ ≥ √δ·(1 − 2⁻²⁴) (√δ is a normal number for any
//   float δ > 0), so δ / RN√δ ≤ √δ·(1 + 2⁻²³) ≤ RU√δ⁺·(1 + 2⁻²²) and ε_num ≤
//   ε⁺. Likewise ε_t ≤ εt⁺ (ε_s ≤ εs_max). If D ≤ 0, dc ≥ 0 ≥ D; if D > 0,
//   d2 > T ≥ D² gives √d2 > D and dc = RN√d2 ≥ D (D is a float). Either way
//   dc − ε_t ≥ D − εt⁺ ≥ succ(cut) (real arithmetic, D ≥ succ(cut) + εt⁺),
//   so x = RN(dc − ε_t) ≥ succ(cut) > cut and lb = max(x, 0) > cut. A NaN d2
//   fails d2 > T and goes to the chain, so NaN behaviour is unchanged; a
//   pair whose lb equals the cut (a tie at the tail with a lower position)
//   is never dropped. Pairs that pass run the chain and the θ and tail tests
//   as before. Once the runs have filled, nearly every pair costs its dot
//   and five fp32 operations, not two √ and a ÷.
// - The chain and the runs. A pair that passes the screen waits in its
//   warp's queue; 32 at a time, one a lane, they run the exact chain, and
//   those with lb <= the cut join their query's candidate list, which merges
//   into the run 32 or more at a time (csrc/run_merge.cuh: an in-place merge
//   by counting, the whole warp busy). Up to
//   mp = 512 the runs sit in shared memory; past it each query keeps a
//   warp-wide run of mp entries in device memory (csrc/wide_run.cuh).
// - An optional counter (null on the main path) takes the number of live
//   pairs screened and of pairs that reached the exact chain.
//
// Rows of S tiles whose size is no multiple of 16 bytes are read from device
// memory directly (no bulk copy).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "run_merge.cuh"
#include "wide_run.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMergeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDeltaRel = 2e-6f;  // quant_topk.NUM_DELTA_REL
constexpr float kTolAbs = 1e-7f;    // quant_topk.NUM_TOL_ABS
constexpr float kEpsNumUp = 1.0f + 0x1p-22f;
constexpr int kCap = 64;            // candidates of a query waiting to merge into its run
constexpr int kQueue = 160;         // pairs of a warp waiting for the exact chain (31 + 4·32)

// ---- the exact chain (coarse_lb_tile's order, each op rounded on its own)

__device__ __forceinline__ float coarse_d2(float qs2, float coef, int c) {
  return __fsub_rn(qs2, __fmul_rn(coef, static_cast<float>(c)));
}

__device__ __forceinline__ float coarse_lb(float d2, float qs2, float seps, float qe) {
  const float dc = __fsqrt_rn(fmaxf(d2, 0.f));
  const float delta = __fmul_rn(kDeltaRel, qs2);
  const float eps_num = __fdiv_rn(delta, fmaxf(dc, __fsqrt_rn(delta)));
  const float eps_t = __fadd_rn(__fadd_rn(__fadd_rn(seps, qe), eps_num), kTolAbs);
  const float x = __fsub_rn(dc, eps_t);
  return x != x ? x : fmaxf(x, 0.f);
}

// The screen's limit on d2 (see the header): a pair with d2 > T has lb > cut.
__device__ __forceinline__ float screen_limit(float cut, float qe, float q2, float seps_max,
                                              float s2_max) {
  const float delta = __fmul_ru(kDeltaRel, __fadd_ru(q2, s2_max));
  const float eps_num = __fmul_ru(__fsqrt_ru(delta), kEpsNumUp);
  const float eps_t = __fadd_ru(__fadd_ru(__fadd_ru(seps_max, qe), eps_num), kTolAbs);
  const float dd = __fadd_ru(nextafterf(cut, CUDART_INF_F), eps_t);
  return dd > 0.f ? __fmul_ru(dd, dd) : -CUDART_INF_F;
}

// ---- the bulk copy (TMA 1-D) onto an mbarrier

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Wait for the phase of parity `parity` to complete. A copy that never lands
// traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spin > (1LL << 26)) __trap();
  }
}

__device__ __forceinline__ int pack4(const int8_t* src, int j0, int d) {
  int packed = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (j0 + b < d) packed |= (static_cast<int>(src[j0 + b]) & 0xff) << (8 * b);
  }
  return packed;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Words between packed rows: a multiple of 4 (16-byte loads) that is 4 mod
// 8, so the rows 32 lanes read in one 16-byte load fall in distinct bank
// groups.
__host__ __device__ __forceinline__ int row_stride(int nw4) { return nw4 % 8 == 4 ? nw4 : nw4 + 4; }

// The first slot at or past v whose tile is in range (block-uniform).
__device__ __forceinline__ int next_slot(const int* srow, int v, int v_hi, int ns_tiles) {
  while (v < v_hi) {
    const int t = srow[v];
    if (t >= 0 && t < ns_tiles) break;
    ++v;
  }
  return v;
}

// Bulk-copy chunk c0 of S tile t: its codes, ε_s and alive, onto one barrier.
__device__ __forceinline__ void issue_chunk(const int8_t* si, const __half* seps,
                                            const float* alive, int t, int c0, int bn, int chunk,
                                            int d, int8_t* raw, __half* eps_raw, float* alive_raw,
                                            uint64_t* bar) {
  const long long base = static_cast<long long>(t) * bn + c0;
  const int rows = min(chunk, bn - c0);
  const unsigned cb = static_cast<unsigned>(rows) * d;
  mbar_expect(bar, cb + rows * 6u);
  bulk_copy(raw, si + base * d, cb, bar);
  bulk_copy(eps_raw, seps + base, rows * 2u, bar);
  bulk_copy(alive_raw, alive + base, rows * 4u, bar);
}

// Shared memory of one block, carved at run time (sizes depend on qb, mp,
// the padded row width nw4 and the chunk).
struct Layout {
  size_t run_lb, run_pos, c_lb, c_pos, c_n, queue, qw, qf, qst, raw, eps_raw, alive_raw, packed,
      s2, seps, bar, maxes, total;
  __host__ __device__ static Layout make(int qb, int mp, int nw4, int chunk, int d, bool wide) {
    Layout L{};
    size_t at = 0;
    const int run_n = wide ? 0 : mp;
    L.run_lb = at;
    at = align16(at + static_cast<size_t>(qb) * run_n * 4);
    L.run_pos = at;
    at = align16(at + static_cast<size_t>(qb) * run_n * 4);
    L.c_lb = at;  // candidates waiting to merge, per query
    at = align16(at + static_cast<size_t>(qb) * kCap * 4);
    L.c_pos = at;
    at = align16(at + static_cast<size_t>(qb) * kCap * 4);
    L.c_n = at;
    at = align16(at + static_cast<size_t>(qb) * 4);
    L.queue = at;  // per warp: pairs that passed the screen, 5 words each
    at = align16(at + static_cast<size_t>(kWarps) * kQueue * 5 * 4);
    L.qw = at;  // query words
    at = align16(at + static_cast<size_t>(qb) * nw4 * 4);
    L.qf = at;  // per query: q2, qe, th, qsc, T, coef, tail_d (wide), shared bound
    at = align16(at + static_cast<size_t>(qb) * 8 * 4);
    L.qst = at;  // per query: cur, tail_p (wide)
    at = align16(at + static_cast<size_t>(qb) * 2 * 4);
    const size_t code_bytes = align16(static_cast<size_t>(chunk) * d) + 16;
    L.raw = at;
    at = align16(at + 2 * code_bytes);
    L.eps_raw = at;
    at = align16(at + 2 * align16(static_cast<size_t>(chunk) * 2));
    L.alive_raw = at;
    at = align16(at + 2 * static_cast<size_t>(chunk) * 4);
    L.packed = at;
    at = align16(at + static_cast<size_t>(chunk) * row_stride(nw4) * 4);
    L.s2 = at;
    at = align16(at + static_cast<size_t>(chunk) * 4);
    L.seps = at;
    at = align16(at + static_cast<size_t>(chunk) * 4);
    L.bar = at;
    at = align16(at + 16);
    L.maxes = at;
    at = align16(at + 16);
    L.total = at;
    return L;
  }
  __host__ __device__ size_t code_bytes(int chunk, int d) const {
    return align16(static_cast<size_t>(chunk) * d) + 16;
  }
};

enum { kQ2 = 0, kQE, kTH, kQSC, kT, kCOEF, kTAILD, kG };  // per-query floats, each qb wide
enum { kCUR = 0, kTAILP };                            // per-query ints (wide runs)

// The shared-memory state of a block's queries, as offsets from one base:
// per-query floats (qf, `qb` wide each) and ints (qst), runs, candidate lists
// and the warps' queues. Every helper below is called by all lanes of a warp
// with warp-uniform arguments.
struct Queries {
  float* qf;
  int* qst;
  float* run_lb;
  int* run_pos;
  float* c_lb;
  int* c_pos;
  int* c_n;
  int qb, mp;

  __device__ __forceinline__ float& f(int field, int q) const { return qf[field * qb + q]; }
  __device__ __forceinline__ int& i(int field, int q) const { return qst[field * qb + q]; }
};

template <bool WIDE>
__device__ __forceinline__ float run_tail(const Queries& Q, int q) {
  return WIDE ? Q.f(kTAILD, q) : Q.run_lb[q * Q.mp + Q.mp - 1];
}

template <bool WIDE>
__device__ __forceinline__ float query_limit(const Queries& Q, int q, float seps_max,
                                             float s2_max) {
  return screen_limit(fminf(fminf(Q.f(kTH, q), run_tail<WIDE>(Q, q)), Q.f(kG, q)), Q.f(kQE, q),
                      Q.f(kQ2, q), seps_max, s2_max);
}

// Merge query q's waiting candidates into its run (wide: the two buffers of
// mp entries at part_lb / part_pos + at), then tighten its limit.
template <bool WIDE>
__device__ __forceinline__ void merge_query(const Queries& Q, int q, float* part_lb, int* part_pos,
                                            long long at, unsigned* bound, float seps_max,
                                            float s2_max, int lane) {
  float* cl = Q.c_lb + q * kCap;
  int* cp = Q.c_pos + q * kCap;
  const int n = Q.c_n[q];
  __syncwarp();
  if (!WIDE) {
    repro_torch::merge_into_run(Q.run_lb + q * Q.mp, Q.run_pos + q * Q.mp, Q.mp, cl, cp, n, lane);
  } else {
    repro_torch::WideRun<kCap> wr;
    wr.rd[0] = part_lb + at;
    wr.rp[0] = part_pos + at;
    wr.rd[1] = part_lb + at + Q.mp;
    wr.rp[1] = part_pos + at + Q.mp;
    wr.bd = cl;
    wr.bp = cp;
    wr.k = Q.mp;
    wr.cur = Q.i(kCUR, q);
    wr.nb = n;
    wr.tail_d = Q.f(kTAILD, q);
    wr.tail_p = Q.i(kTAILP, q);
    wr.flush();
    __syncwarp();
    if (lane == 0) {
      Q.i(kCUR, q) = wr.cur;
      Q.f(kTAILD, q) = wr.tail_d;
      Q.i(kTAILP, q) = wr.tail_p;
    }
    __syncwarp();
  }
  // a full run's tail bounds the query's final mp-th lb: share it with the
  // other splits (lb >= 0, so its bits order as unsigned)
  const float tail = run_tail<WIDE>(Q, q);
  if (lane == 0 && tail < CUDART_INF_F) {
    const unsigned g = atomicMin(bound, __float_as_uint(tail));
    Q.f(kG, q) = fminf(__uint_as_float(g), tail);
  }
  __syncwarp();
  const float tn = query_limit<WIDE>(Q, q, seps_max, s2_max);
  __syncwarp();
  if (lane == 0) {
    Q.c_n[q] = 0;
    Q.f(kT, q) = tn;
  }
  __syncwarp();
}

// Run the exact chain on the last `take` pairs of the warp's queue (query
// offset, position, d2, q2 + s2, ε_s: kQueue each), one a lane; hand the
// ones that may enter (lb <= θ, lb <= the run's tail and lb <= the shared
// bound: the merge orders ties) to their queries' candidate lists, merging a
// list once it holds 32. Returns the queue's new length.
template <bool WIDE>
__device__ __forceinline__ int drain_queue(const Queries& Q, int* qu, int take, int queued,
                                           int q0, int qpw, float* part_lb, int* part_pos,
                                           long long part0, unsigned* bound, float seps_max,
                                           float s2_max, int lane) {
  int* qu_q = qu;
  int* qu_p = qu_q + kQueue;
  float* qu_d2 = reinterpret_cast<float*>(qu_p + kQueue);
  float* qu_qs2 = qu_d2 + kQueue;
  float* qu_se = qu_qs2 + kQueue;
  const int e = queued - take + lane;
  const bool in = lane < take;
  const int qq = in ? qu_q[e] : 0;
  const int q = q0 + qq;
  float lb = CUDART_INF_F;
  bool keep = false;
  int p = -1;
  if (in) {
    p = qu_p[e];
    lb = coarse_lb(qu_d2[e], qu_qs2[e], qu_se[e], Q.f(kQE, q));
    keep = lb <= Q.f(kTH, q) && lb <= run_tail<WIDE>(Q, q) && lb <= Q.f(kG, q);
  }
  __syncwarp();
  for (int k2 = 0; k2 < qpw; ++k2) {
    const unsigned m = __ballot_sync(kFull, keep && qq == k2);
    if (m == 0u) continue;  // warp-uniform
    const int qk = q0 + k2;
    const int n0 = Q.c_n[qk];
    __syncwarp();
    if (keep && qq == k2) {
      const int at = n0 + __popc(m & ((1u << lane) - 1u));
      Q.c_lb[qk * kCap + at] = lb;
      Q.c_pos[qk * kCap + at] = p;
    }
    if (lane == 0) Q.c_n[qk] = n0 + __popc(m);
    __syncwarp();
    if (n0 + __popc(m) >= 32)
      merge_query<WIDE>(Q, qk, part_lb, part_pos, part0 + qk * 2LL * Q.mp, bound + qk, seps_max,
                        s2_max, lane);
  }
  return queued - take;
}

// MAXW: packed words of a row held in registers at a time for the __dp4a dot
// (4 or 8: d <= 32), or 0 for the tensor-core dot (d > 32). QPW: queries a
// warp serves (1, 2 or 4; qb = 16·QPW). WIDE: runs past 512 entries in
// device memory.
template <int MAXW, int QPW, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
quant_coarse_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qscale,
                    const float* __restrict__ qeps, const float* __restrict__ theta,
                    const int8_t* __restrict__ si, const float* __restrict__ sscale,
                    const __half* __restrict__ seps, const float* __restrict__ alive,
                    const int* __restrict__ sched, const int* __restrict__ counts,
                    float* __restrict__ out_lb, int* __restrict__ out_pos,
                    float* __restrict__ part_lb, int* __restrict__ part_pos,
                    unsigned* __restrict__ bound, unsigned long long* __restrict__ stats, int n_r,
                    int n_s, int d, int mp, int bm, int bn, int max_visits, int chunk, int per,
                    int splits, int bulk) {
  constexpr int QB = QPW * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (d + 3) >> 2;
  // words a packed row holds: a multiple of 4 (16-byte loads), of 8 for the
  // tensor-core dot (32 codes a step)
  const int nw4 = MAXW == 0 ? (nw + 7) & ~7 : (nw + 3) & ~3;
  const int sw = row_stride(nw4);
  const Layout L = Layout::make(QB, mp, nw4, chunk, d, WIDE);
  float* run_lb = reinterpret_cast<float*>(smem + L.run_lb);
  int* run_pos = reinterpret_cast<int*>(smem + L.run_pos);
  float* c_lb = reinterpret_cast<float*>(smem + L.c_lb);
  int* c_pos = reinterpret_cast<int*>(smem + L.c_pos);
  int* c_n = reinterpret_cast<int*>(smem + L.c_n);
  int* qw_s = reinterpret_cast<int*>(smem + L.qw);
  float* qf = reinterpret_cast<float*>(smem + L.qf);
  int* qst = reinterpret_cast<int*>(smem + L.qst);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + L.raw);
  __half* eps_raw = reinterpret_cast<__half*>(smem + L.eps_raw);
  float* alive_raw = reinterpret_cast<float*>(smem + L.alive_raw);
  int* packed = reinterpret_cast<int*>(smem + L.packed);
  float* s2_s = reinterpret_cast<float*>(smem + L.s2);
  float* seps_s = reinterpret_cast<float*>(smem + L.seps);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  unsigned* maxes = reinterpret_cast<unsigned*>(smem + L.maxes);  // ε_s max, s2 max (bits)
  const size_t code_stride = L.code_bytes(chunk, d);
  const int eps_stride = static_cast<int>(align16(static_cast<size_t>(chunk) * 2) / 2);

  const int qb = blockIdx.x;
  const int tile_r = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(tile_r) * bm + static_cast<long long>(qb) * QB;
  if (qb * QB >= bm || row0 >= n_r) return;  // block-uniform: no live query
  const int nq = static_cast<int>(min(static_cast<long long>(min(QB, bm - qb * QB)), n_r - row0));
  const int ns_tiles = n_s / bn;
  const Queries Q{qf, qst, run_lb, run_pos, c_lb, c_pos, c_n, QB, mp};
  int* qu = reinterpret_cast<int*>(smem + L.queue) + warp * kQueue * 5;
  // each query's wide run: two buffers of mp at part0 + q·2mp
  const long long part0 = (static_cast<long long>(split) * n_r + row0) * 2LL * mp;
  float seps_max = 0.f, s2_max = 0.f;  // the current chunk's
  int* qu_q = qu;
  int* qu_p = qu_q + kQueue;
  float* qu_d2 = reinterpret_cast<float*>(qu_p + kQueue);
  float* qu_qs2 = qu_d2 + kQueue;
  float* qu_se = qu_qs2 + kQueue;

  // the block's queries: packed words, q2, and their runs
  for (int q = tid; q < QB; q += kThreads) {
    const bool act = q < nq;
    const long long row = row0 + q;
    int qa = 0;
    for (int wd = 0; wd < nw4; ++wd) {
      const int word = (act && wd < nw) ? pack4(qi + row * d, 4 * wd, d) : 0;
      qw_s[q * nw4 + wd] = word;
      qa = __dp4a(word, word, qa);
    }
    const float qsc = act ? qscale[row] : 1.f;
    qf[kQ2 * QB + q] = __fmul_rn(__fmul_rn(qsc, qsc), static_cast<float>(qa));
    qf[kQE * QB + q] = act ? qeps[row] : 0.f;
    qf[kTH * QB + q] = act ? theta[row] : -CUDART_INF_F;
    qf[kQSC * QB + q] = qsc;
    qf[kTAILD * QB + q] = CUDART_INF_F;
    qf[kG * QB + q] = CUDART_INF_F;
    qst[kCUR * QB + q] = 0;
    qst[kTAILP * QB + q] = -1;
    c_n[q] = 0;
  }
  if (!WIDE) {
    for (int e = tid; e < QB * mp; e += kThreads) {
      run_lb[e] = CUDART_INF_F;
      run_pos[e] = -1;
    }
  } else {
    for (int q = warp; q < nq; q += kWarps) {
      const long long at = (static_cast<long long>(split) * n_r + row0 + q) * 2LL * mp;
      for (int j = lane; j < mp; j += 32) {
        part_lb[at + j] = CUDART_INF_F;
        part_pos[at + j] = -1;
      }
    }
  }
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();

  // the block's items: chunk c0 of the S tile in slot v, for the slots of
  // this split; out-of-range tiles are skipped (block-uniform)
  const int cnt = min(counts[tile_r], max_visits);
  const int v_lo = split * per;
  const int v_hi = min(cnt, v_lo + per);
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;

  int queued = 0;                              // the warp's queue length
  unsigned long long n_live = 0, n_chain = 0;  // warp-uniform counts
  int v = next_slot(srow, v_lo, v_hi, ns_tiles), c0 = 0;
  if (bulk && v < v_hi && tid == 0)
    issue_chunk(si, seps, alive, srow[v], 0, bn, chunk, d, raw, eps_raw, alive_raw, &bar[0]);
  for (int it = 0; v < v_hi; ++it) {
    const int buf = it & 1;
    const int t = srow[v];
    const long long base = static_cast<long long>(t) * bn + c0;
    const int rows = min(chunk, bn - c0);
    int nv = v, nc0 = c0 + chunk;
    if (nc0 >= bn) {
      nc0 = 0;
      nv = next_slot(srow, v + 1, v_hi, ns_tiles);
    }
    if (bulk) mbar_wait(&bar[buf], (it >> 1) & 1);
    __syncthreads();  // this chunk has landed; the last chunk's scan is done
    if (bulk && nv < v_hi && tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_chunk(si, seps, alive, srow[nv], nc0, bn, chunk, d, raw + (buf ^ 1) * code_stride,
                  eps_raw + (buf ^ 1) * eps_stride, alive_raw + (buf ^ 1) * chunk, &bar[buf ^ 1]);
    }
    // repack the rows into zero-padded words
    const int8_t* src = raw + buf * code_stride;
    for (int e = tid; e < rows * nw4; e += kThreads) {
      const int rr = e / nw4;
      const int wd = e - rr * nw4;
      int word = 0;
      if (wd < nw) word = bulk ? pack4(src + static_cast<size_t>(rr) * d, 4 * wd, d)
                               : pack4(si + (base + rr) * d, 4 * wd, d);
      packed[rr * sw + wd] = word;
    }
    if (tid == 0) {
      maxes[0] = 0u;
      maxes[1] = 0u;
    }
    __syncthreads();
    const float ssc = sscale[t];
    const float ssc2 = __fmul_rn(ssc, ssc);
    for (int r0 = warp * 32; r0 < rows; r0 += kThreads) {
      const int rr = r0 + lane;
      unsigned m_se = 0u, m_s2 = 0u;
      if (rr < rows) {
        int sq = 0;
        for (int w4 = 0; w4 < nw4; w4 += 4) {
          const int4 a = *reinterpret_cast<const int4*>(packed + rr * sw + w4);
          sq = __dp4a(a.x, a.x, sq);
          sq = __dp4a(a.y, a.y, sq);
          sq = __dp4a(a.z, a.z, sq);
          sq = __dp4a(a.w, a.w, sq);
        }
        const float al = bulk ? alive_raw[buf * chunk + rr] : alive[base + rr];
        const float se = __half2float(bulk ? eps_raw[buf * eps_stride + rr] : seps[base + rr]);
        const float s2 = __fmul_rn(ssc2, static_cast<float>(sq));
        const bool live = al > 0.f;
        s2_s[rr] = live ? s2 : -1.f;  // -1 marks a dead row
        seps_s[rr] = se;
        if (live) {
          m_se = __float_as_uint(fmaxf(se, 0.f));
          m_s2 = __float_as_uint(fmaxf(s2, 0.f));
        }
      }
      m_se = __reduce_max_sync(kFull, m_se);
      m_s2 = __reduce_max_sync(kFull, m_s2);
      if (lane == 0) {
        atomicMax(&maxes[0], m_se);
        atomicMax(&maxes[1], m_s2);
      }
    }
    __syncthreads();
    seps_max = __uint_as_float(maxes[0]);
    s2_max = __uint_as_float(maxes[1]);
    // this chunk's coef and limit T of the warp's queries, with the bound
    // the other splits have shared so far
    if (lane < QPW) {
      const int q = warp * QPW + lane;
      qf[kCOEF * QB + q] = __fmul_rn(2.f, __fmul_rn(qf[kQSC * QB + q], ssc));
      if (q < nq) qf[kG * QB + q] = fminf(qf[kG * QB + q], __uint_as_float(__ldcg(bound + row0 + q)));
      qf[kT * QB + q] = query_limit<WIDE>(Q, q, seps_max, s2_max);
    }
    __syncwarp();
    // the warp's queries' q2, coef and limit, in registers for the chunk
    float q2r[QPW], coefr[QPW], tr[QPW];
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq) {
      q2r[qq] = qf[kQ2 * QB + warp * QPW + qq];
      coefr[qq] = qf[kCOEF * QB + warp * QPW + qq];
      tr[qq] = qf[kT * QB + warp * QPW + qq];
    }

    // the tensor-core path's queries: this lane's two columns of the warp's
    // 8 (2·(lane % 4) and the next; only the first QPW are queries)
    const int tq = lane & 3;
    const int g = lane >> 2;
    float q2x[2], coefx[2], tx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qq = min(2 * tq + h, QPW - 1);
      q2x[h] = q2r[qq];
      coefx[h] = coefr[qq];
      tx[h] = tr[qq];
    }
    const int nvq = max(0, min(QPW, nq - warp * QPW));  // the warp's live queries

    if constexpr (MAXW == 0) {
      // d > 32: the integer dots on the tensor cores (mma.sync m16n8k32
      // s8·s8 → s32, exact): 32 rows (two m-tiles of 16) by 8 columns (the
      // warp's queries, zero past QPW) a step of 32 codes
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const bool live_l = r0 + lane < rows && s2_s[r0 + lane] >= 0.f;
        n_live += static_cast<unsigned>(__popc(__ballot_sync(kFull, live_l))) *
                  static_cast<unsigned>(nvq);
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        const bool bq = g < nvq;
        const int* qrow = qw_s + (warp * QPW + (bq ? g : 0)) * nw4;
        for (int w0 = 0; w0 < nw4; w0 += 8) {
          const int b0 = bq ? qrow[w0 + tq] : 0;
          const int b1 = bq ? qrow[w0 + tq + 4] : 0;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int ra = r0 + 16 * mt + g;
            const int rb = ra + 8;
            const int a0 = ra < rows ? packed[ra * sw + w0 + tq] : 0;
            const int a1 = rb < rows ? packed[rb * sw + w0 + tq] : 0;
            const int a2 = ra < rows ? packed[ra * sw + w0 + tq + 4] : 0;
            const int a3 = rb < rows ? packed[rb * sw + w0 + tq + 4] : 0;
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
                "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(acc[mt][0]), "+r"(acc[mt][1]), "+r"(acc[mt][2]), "+r"(acc[mt][3])
                : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
          }
        }
        // acc[mt][i]: row r0 + 16·mt + g + 8·(i / 2), query 2·tq + i % 2
        float s2v[4];
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          const int row = r0 + 16 * (sl >> 1) + g + 8 * (sl & 1);
          s2v[sl] = row < rows ? s2_s[row] : -1.f;
        }
        unsigned pm[8];
        unsigned any = 0u;
#pragma unroll
        for (int v8 = 0; v8 < 8; ++v8) {
          const int mt = v8 >> 2, i = v8 & 3, h = i & 1;
          const float s2 = s2v[2 * mt + (i >> 1)];
          const float d2 = coarse_d2(__fadd_rn(q2x[h], s2), coefx[h], acc[mt][i]);
          pm[v8] = __ballot_sync(kFull, 2 * tq + h < nvq && s2 >= 0.f && !(d2 > tx[h]));
          any |= pm[v8];
        }
        if (any == 0u) continue;  // warp-uniform: the common case
#pragma unroll
        for (int v8 = 0; v8 < 8; ++v8) {
          if (pm[v8] == 0u) continue;  // warp-uniform
          n_chain += __popc(pm[v8]);
          if (pm[v8] & (1u << lane)) {
            const int mt = v8 >> 2, i = v8 & 3, h = i & 1;
            const int row = r0 + 16 * mt + g + 8 * (i >> 1);
            const float qs2 = __fadd_rn(q2x[h], s2v[2 * mt + (i >> 1)]);
            const int at = queued + __popc(pm[v8] & ((1u << lane) - 1u));
            qu_q[at] = 2 * tq + h;
            qu_p[at] = static_cast<int>(base + row);
            qu_d2[at] = coarse_d2(qs2, coefx[h], acc[mt][i]);
            qu_qs2[at] = qs2;
            qu_se[at] = seps_s[row];
          }
          queued += __popc(pm[v8]);
        }
        __syncwarp();
        if (queued >= 32) {
          do {
            queued = drain_queue<WIDE>(Q, qu, 32, queued, warp * QPW, QPW, part_lb, part_pos,
                                       part0, bound + row0, seps_max, s2_max, lane);
          } while (queued >= 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) tx[h] = qf[kT * QB + warp * QPW + min(2 * tq + h, QPW - 1)];
        }
      }
    } else
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int rr = r0 + lane;
      const bool in = rr < rows;
      const float s2 = in ? s2_s[rr] : -1.f;
      const bool live = s2 >= 0.f;
      n_live += static_cast<unsigned>(__popc(__ballot_sync(kFull, live))) *
                static_cast<unsigned>(nvq);
      // the exact integer dots of this lane's row with the warp's queries:
      // the row's words in registers MAXW at a time, the queries' words
      // broadcast from shared memory
      int c[QPW];
#pragma unroll
      for (int qq = 0; qq < QPW; ++qq) c[qq] = 0;
      for (int w0 = 0; w0 < nw4; w0 += (MAXW > 0 ? MAXW : 4)) {
        int rw[MAXW > 0 ? MAXW : 4];
#pragma unroll
        for (int w4 = 0; w4 < (MAXW > 0 ? MAXW : 4) / 4; ++w4) {
          int4 v4 = make_int4(0, 0, 0, 0);
          if (in && w0 + 4 * w4 < nw4)
            v4 = *reinterpret_cast<const int4*>(packed + rr * sw + w0 + 4 * w4);
          rw[4 * w4] = v4.x;
          rw[4 * w4 + 1] = v4.y;
          rw[4 * w4 + 2] = v4.z;
          rw[4 * w4 + 3] = v4.w;
        }
#pragma unroll
        for (int qq = 0; qq < QPW; ++qq) {
          if (warp * QPW + qq < nq) {  // warp-uniform
            const int4* qv = reinterpret_cast<const int4*>(qw_s + (warp * QPW + qq) * nw4 + w0);
#pragma unroll
            for (int w4 = 0; w4 < (MAXW > 0 ? MAXW : 4) / 4; ++w4) {
              if (w0 + 4 * w4 < nw4) {
                const int4 a = qv[w4];
                c[qq] = __dp4a(a.x, rw[4 * w4], c[qq]);
                c[qq] = __dp4a(a.y, rw[4 * w4 + 1], c[qq]);
                c[qq] = __dp4a(a.z, rw[4 * w4 + 2], c[qq]);
                c[qq] = __dp4a(a.w, rw[4 * w4 + 3], c[qq]);
              }
            }
          }
        }
      }
      // the screen: d2 as the chain computes it, against each query's limit
      unsigned pm[QPW];
      unsigned any = 0u;
#pragma unroll
      for (int qq = 0; qq < QPW; ++qq) {
        const float d2 = coarse_d2(__fadd_rn(q2r[qq], s2), coefr[qq], c[qq]);
        pm[qq] = warp * QPW + qq < nq ? __ballot_sync(kFull, live && !(d2 > tr[qq])) : 0u;
        any |= pm[qq];
      }
      if (any == 0u) continue;  // warp-uniform: the common case
      // the pairs that passed wait in the warp's queue for the exact chain
      const float se = in ? seps_s[rr] : 0.f;
#pragma unroll
      for (int qq = 0; qq < QPW; ++qq) {
        if (pm[qq] == 0u) continue;  // warp-uniform
        n_chain += __popc(pm[qq]);
        if (pm[qq] & (1u << lane)) {
          const int at = queued + __popc(pm[qq] & ((1u << lane) - 1u));
          const float qs2 = __fadd_rn(q2r[qq], s2);
          qu_q[at] = qq;
          qu_p[at] = static_cast<int>(base + rr);
          qu_d2[at] = coarse_d2(qs2, coefr[qq], c[qq]);
          qu_qs2[at] = qs2;
          qu_se[at] = se;
        }
        queued += __popc(pm[qq]);
      }
      __syncwarp();
      if (queued >= 32) {
        do {
          queued = drain_queue<WIDE>(Q, qu, 32, queued, warp * QPW, QPW, part_lb, part_pos, part0,
                                     bound + row0, seps_max, s2_max, lane);
        } while (queued >= 32);
#pragma unroll
        for (int qq = 0; qq < QPW; ++qq) tr[qq] = qf[kT * QB + warp * QPW + qq];
      }
    }
    v = nv;
    c0 = nc0;
  }
  if (queued > 0)
    drain_queue<WIDE>(Q, qu, queued, queued, warp * QPW, QPW, part_lb, part_pos, part0,
                      bound + row0, seps_max, s2_max, lane);
  for (int qq = 0; qq < QPW; ++qq) {
    const int q = warp * QPW + qq;
    if (q < nq && c_n[q] > 0)  // warp-uniform
      merge_query<WIDE>(Q, q, part_lb, part_pos, part0 + q * 2LL * mp, bound + row0 + q, seps_max,
                        s2_max, lane);
  }

  if (stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], n_live);
    atomicAdd(&stats[1], n_chain);
  }
  // the split's run per query: out (one split) or its partial run
  for (int qq = 0; qq < QPW; ++qq) {
    const int q = warp * QPW + qq;
    if (q >= nq) break;  // warp-uniform
    const long long row = row0 + q;
    const float* kl = run_lb + q * mp;
    const int* kp = run_pos + q * mp;
    if (WIDE) {
      const long long at = (static_cast<long long>(split) * n_r + row) * 2LL * mp;
      const int cur = qst[kCUR * QB + q];
      kl = part_lb + at + cur * mp;
      kp = part_pos + at + cur * mp;
      if (splits > 1) {
        if (cur == 1) {  // the run ends in the second buffer: move it to the first
          for (int j = lane; j < mp; j += 32) {
            part_lb[at + j] = kl[j];
            part_pos[at + j] = kp[j];
          }
        }
        continue;
      }
    }
    if (splits == 1) {
      for (int j = lane; j < mp; j += 32) {
        const float l = kl[j];
        out_lb[row * mp + j] = l;
        out_pos[row * mp + j] = isfinite(l) ? kp[j] : -1;
      }
    } else {
      const long long at = (static_cast<long long>(split) * n_r + row) * mp;
      for (int j = lane; j < mp; j += 32) {
        part_lb[at + j] = kl[j];
        part_pos[at + j] = kp[j];
      }
    }
  }
}

// A warp per query folds the splits' partial runs (rows of `stride`
// entries, the first mp the run) through a wide run in scratch (n_r x 2mp)
// and writes (lb, position), -1 where lb is not finite.
__global__ void __launch_bounds__(kMergeThreads)
quant_merge(const float* __restrict__ part_lb, const int* __restrict__ part_pos,
            float* __restrict__ scratch_lb, int* __restrict__ scratch_pos,
            float* __restrict__ out_lb, int* __restrict__ out_pos, int n_r, int mp, int stride,
            int splits) {
  __shared__ float buf_d[kMergeThreads / 32][kCap];
  __shared__ int buf_p[kMergeThreads / 32][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * (kMergeThreads / 32) + warp;
  if (q >= n_r) return;  // warp-uniform
  repro_torch::WideRun<kCap> run;
  run.init(scratch_lb + q * 2LL * mp, scratch_pos + q * 2LL * mp, scratch_lb + q * 2LL * mp + mp,
           scratch_pos + q * 2LL * mp + mp, buf_d[warp], buf_p[warp], mp);
  for (int sp = 0; sp < splits; ++sp) {
    const long long at = (static_cast<long long>(sp) * n_r + q) * stride;
    for (int i0 = 0; i0 < mp; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < mp;
      const float l = ok ? part_lb[at + i] : 0.f;
      const int p = ok ? part_pos[at + i] : -1;
      run.offer(l, p, ok && p >= 0 && isfinite(l));
    }
  }
  run.flush();
  const float* kl = run.keys();
  const int* kp = run.positions();
  for (int i = lane; i < mp; i += 32) {
    const float l = kl[i];
    out_lb[q * mp + i] = l;
    out_pos[q * mp + i] = isfinite(l) ? kp[i] : -1;
  }
}

struct Args {
  const int8_t* qi;
  const float* qscale;
  const float* qeps;
  const float* theta;
  const int8_t* si;
  const float* sscale;
  const __half* seps;
  const float* alive;
  const int* sched;
  const int* counts;
  float* out_lb;
  int* out_pos;
  float* part_lb;
  int* part_pos;
  float* scratch_lb;
  int* scratch_pos;
  unsigned* bound;
  unsigned long long* stats;
  int n_r, n_s, d, mp, bm, bn, nr_tiles, max_visits, chunk, splits, per, bulk;
  cudaStream_t stream;
};

template <int MAXW, int QPW, bool WIDE>
cudaError_t launch(const Args& a) {
  constexpr int QB = QPW * kWarps;
  const int nw = (a.d + 3) >> 2;
  const int nw4 = MAXW == 0 ? (nw + 7) & ~7 : (nw + 3) & ~3;
  const size_t smem = Layout::make(QB, a.mp, nw4, a.chunk, a.d, WIDE).total;
  if (smem > 227u * 1024u) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(quant_coarse_kernel<MAXW, QPW, WIDE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.bm + QB - 1) / QB, a.nr_tiles, a.splits);
  quant_coarse_kernel<MAXW, QPW, WIDE><<<grid, kThreads, smem, a.stream>>>(
      a.qi, a.qscale, a.qeps, a.theta, a.si, a.sscale, a.seps, a.alive, a.sched, a.counts,
      a.out_lb, a.out_pos, a.part_lb, a.part_pos, a.bound, a.stats, a.n_r, a.n_s, a.d, a.mp, a.bm,
      a.bn,
      a.max_visits, a.chunk, a.per, a.splits, a.bulk);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const unsigned mb = static_cast<unsigned>((a.n_r + kMergeThreads / 32 - 1) / (kMergeThreads / 32));
  quant_merge<<<mb, kMergeThreads, 0, a.stream>>>(a.part_lb, a.part_pos, a.scratch_lb,
                                                  a.scratch_pos, a.out_lb, a.out_pos, a.n_r, a.mp,
                                                  WIDE ? 2 * a.mp : a.mp, a.splits);
  return cudaGetLastError();
}

template <int MAXW>
cudaError_t by_queries(const Args& a, int qpw, bool wide) {
  if (wide) return qpw == 2 ? launch<MAXW, 2, true>(a) : cudaErrorInvalidValue;
  switch (qpw) {
    case 1: return launch<MAXW, 1, false>(a);
    case 2: return launch<MAXW, 2, false>(a);
    case 4: return launch<MAXW, 4, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches the scan and, with several
// splits, the merge pass on `stream`; allocates nothing; returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take: d >=
// 1, mp a power of two, S tile-padded to a multiple of bn, qb = 16·qpw
// queries a block). `bulk` (the caller's check that bn is a multiple of 16
// and the arrays are 16-byte aligned) selects the bulk-copy staging. The
// schedule row of each R tile is cut into `splits` ranges of `per` slots.
// Partial runs: part_lb / part_pos hold splits x n_r x mp entries (wide: 2mp,
// always needed), scratch_lb / scratch_pos n_r x 2mp where splits > 1.
// `bound` (n_r floats, +inf on entry) is where the splits share each query's
// smallest full-run tail. `stats` (null on the main path) gets two counts
// added: live pairs screened and pairs that reached the exact chain.
extern "C" int repro_quant_coarse(const void* qi, const void* qscale, const void* qeps,
                                  const void* theta, const void* si, const void* sscale,
                                  const void* seps, const void* alive, const void* sched,
                                  const void* counts, void* out_lb, void* out_pos, void* part_lb,
                                  void* part_pos, void* scratch_lb, void* scratch_pos, void* bound,
                                  void* stats,
                                  int n_r, int n_s, int d, int mp, int bm, int bn, int nr_tiles,
                                  int max_visits, int qpw, int wide, int chunk, int splits,
                                  int per, int bulk, void* stream) {
  if (d < 1 || mp < 1 || (mp & (mp - 1)) != 0 || bm < 1 || bn < 1 || n_s < bn ||
      n_s % bn != 0 || max_visits < 1 || n_r < 1 || nr_tiles < 1 || nr_tiles > 65535 ||
      chunk < 1 || chunk > bn || splits < 1 || splits > 65535 || per < 1 ||
      static_cast<long long>(splits - 1) * per >= max_visits || (wide != 0) != (mp > 512) ||
      (bulk && (bn % 16 != 0 || chunk % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((splits > 1 || wide) && (part_lb == nullptr || part_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((splits > 1 && (scratch_lb == nullptr || scratch_pos == nullptr)) || bound == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int8_t*>(qi),    static_cast<const float*>(qscale),
         static_cast<const float*>(qeps),   static_cast<const float*>(theta),
         static_cast<const int8_t*>(si),    static_cast<const float*>(sscale),
         static_cast<const __half*>(seps),  static_cast<const float*>(alive),
         static_cast<const int*>(sched),    static_cast<const int*>(counts),
         static_cast<float*>(out_lb),       static_cast<int*>(out_pos),
         static_cast<float*>(part_lb),      static_cast<int*>(part_pos),
         static_cast<float*>(scratch_lb),   static_cast<int*>(scratch_pos),
         static_cast<unsigned*>(bound),     static_cast<unsigned long long*>(stats),
         n_r, n_s, d, mp, bm, bn, nr_tiles, max_visits, chunk, splits, per, bulk,
         static_cast<cudaStream_t>(stream)};
  const bool w = wide != 0;
  cudaError_t err;
  if (d <= 16)
    err = by_queries<4>(a, qpw, w);
  else if (d <= 32)
    err = by_queries<8>(a, qpw, w);
  else
    err = by_queries<0>(a, qpw, w);
  return static_cast<int>(err);
}
