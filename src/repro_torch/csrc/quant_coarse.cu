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
// Layout. Grid (ceil(bm / kWarps), nr_tiles): a block owns kWarps queries of
// one R tile, one warp per query, and walks the tile's whole schedule itself
// (Hopper blocks run unordered, so there is no sequential grid axis to carry a
// run across). Codes are packed four to an int32 (a row of d codes pads to
// ceil(d/4) words with zeros) and contracted with __dp4a. Each scheduled S
// tile is staged in shared memory in row chunks with Σcode², ε_s and liveness
// per row. A warp's run of mp pairs sits in shared memory: each lane scores
// one row, a ballot selects the rows that beat the run's tail, and the warp
// inserts them one at a time (a popcount finds the slot, the tail shifts
// right). Once the run has filled, most rows fail the tail test, so
// insertion is rare.
//
// What bounds it on this card. Per (query, row) pair: ceil(d/4) dp4a plus
// ~16 float32 operations, two of them a correctly rounded √ and one a
// division, while a staged row (d code bytes, ε and liveness) is read from
// HBM once per block and shared by the block's kWarps queries. So it is
// bound by the float32 pipe's issue rate, not by HBM: int8 tiles move a
// quarter of the bytes of the fp32 gather kernel's.
//
// Any width, any mp. The layout above holds the query's packed codes in
// registers (d <= 128) and the run in shared memory (mp <= 512). Past
// either, a second kernel runs on the same grid: it stages 64 S rows and the
// block's queries one 32-word chunk (128 codes) at a time, each lane summing
// the integer dots of two rows across the chunks (exact, so the order does
// not matter), and keeps each query's shortlist in a warp-wide run of mp
// entries in device memory (csrc/wide_run.cuh). The lb chain is the same
// code, so both kernels give the same bits.
//
// This is the simple, right first version: no wgmma int8 tensor-core dot,
// no TMA staging, no early-out on θ before the √ chain. Those come in later
// PRs.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "wide_run.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDeltaRel = 2e-6f;  // quant_topk.NUM_DELTA_REL
constexpr float kTolAbs = 1e-7f;    // quant_topk.NUM_TOL_ABS
constexpr int kRC = 64;             // S rows per chunk of the general kernel (two per lane)
constexpr int kWC = 32;             // packed words (128 codes) per staged chunk
constexpr int kCap = 64;            // candidate buffer of a wide run

// The certified lower bound of one (query, row) pair from its exact integer
// parts, in coarse_lb_tile's order, every operation rounded on its own.
__device__ __forceinline__ float coarse_lb(float q2, float ssc2, float coef, float qe, int c,
                                          int sq, float seps) {
  const float s2 = __fmul_rn(ssc2, static_cast<float>(sq));
  const float qs2 = __fadd_rn(q2, s2);
  const float d2 = __fsub_rn(qs2, __fmul_rn(coef, static_cast<float>(c)));
  const float dc = __fsqrt_rn(fmaxf(d2, 0.f));
  const float delta = __fmul_rn(kDeltaRel, qs2);
  const float eps_num = __fdiv_rn(delta, fmaxf(dc, __fsqrt_rn(delta)));
  const float eps_t = __fadd_rn(__fadd_rn(__fadd_rn(seps, qe), eps_num), kTolAbs);
  const float x = __fsub_rn(dc, eps_t);
  return x != x ? x : fmaxf(x, 0.f);
}

// (lb, position) order; the empty slot's -1 compares as the largest position
__device__ __forceinline__ bool before(float a, int pa, float b, int pb) {
  return a < b || (a == b && static_cast<unsigned>(pa) < static_cast<unsigned>(pb));
}

// Warp-cooperative insertion of (cl, cp) into the ascending run
// lbv/posv[0:mp]; the run's largest entry drops out.
__device__ __forceinline__ void run_insert(float* lbv, int* posv, int mp, float cl, int cp,
                                           int lane) {
  int ins = 0;  // entries before the candidate form a prefix of the run
  for (int j0 = 0; j0 < mp; j0 += 32) {
    const int j = j0 + lane;
    ins += __popc(__ballot_sync(kFull, j < mp && before(lbv[j], posv[j], cl, cp)));
  }
  if (ins >= mp) return;
  // shift [ins, mp - 1) one slot right, 32 slots at a time from the end:
  // each segment reads its predecessors before any of them is overwritten
  for (int j0 = ((mp - 1) / 32) * 32; j0 >= 0 && j0 + 31 >= ins; j0 -= 32) {
    const int j = j0 + lane;
    const bool write = j < mp && j >= ins;
    float vl = cl;
    int vp = cp;
    if (write && j > ins) {
      vl = lbv[j - 1];
      vp = posv[j - 1];
    }
    __syncwarp();
    if (write) {
      lbv[j] = vl;
      posv[j] = vp;
    }
    __syncwarp();
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

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
quant_coarse_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qscale,
                    const float* __restrict__ qeps, const float* __restrict__ theta,
                    const int8_t* __restrict__ si, const float* __restrict__ sscale,
                    const __half* __restrict__ seps, const float* __restrict__ alive,
                    const int* __restrict__ sched, const int* __restrict__ counts,
                    float* __restrict__ out_lb, int* __restrict__ out_pos, int n_r, int n_s,
                    int d, int mp, int bm, int bn, int max_visits, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (d + 3) >> 2;  // packed words per row
  float* run_lb = reinterpret_cast<float*>(smem);               // kWarps x mp
  int* run_pos = reinterpret_cast<int*>(run_lb + kWarps * mp);  // kWarps x mp
  int* s_code = run_pos + kWarps * mp;                          // chunk x nw
  int* s_sq = s_code + chunk * nw;                              // chunk; -1 marks a dead row
  float* s_eps = reinterpret_cast<float*>(s_sq + chunk);        // chunk

  const int tile_r = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_local = blockIdx.x * kWarps + warp;
  const long long row = static_cast<long long>(tile_r) * bm + q_local;
  const bool active = q_local < bm && row < n_r;  // uniform across the warp
  const int ns_tiles = n_s / bn;

  float* my_lb = run_lb + warp * mp;
  int* my_pos = run_pos + warp * mp;
  for (int j = lane; j < mp; j += 32) {
    my_lb[j] = CUDART_INF_F;
    my_pos[j] = -1;
  }

  int qw[MAXW];
  float qsc = 1.f, qe = 0.f, th = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) qw[w] = (active && w < nw) ? pack4(qi + row * d, 4 * w, d) : 0;
  if (active) {
    qsc = qscale[row];
    qe = qeps[row];
    th = theta[row];
  }
  int qa = 0;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) qa = __dp4a(qw[w], qw[w], qa);
  const float q2 = __fmul_rn(__fmul_rn(qsc, qsc), static_cast<float>(qa));
  __syncwarp();

  const int cnt = min(counts[tile_r], max_visits);
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;
  for (int v = 0; v < cnt; ++v) {
    const int t = srow[v];
    if (t < 0 || t >= ns_tiles) continue;  // nothing to read (block-uniform)
    const float ssc = sscale[t];
    const float ssc2 = __fmul_rn(ssc, ssc);
    const float coef = __fmul_rn(2.f, __fmul_rn(qsc, ssc));
    const long long base = static_cast<long long>(t) * bn;
    for (int c0 = 0; c0 < bn; c0 += chunk) {
      const int rows = min(chunk, bn - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < rows * nw; e += kThreads) {
        const int rr = e / nw;
        const int w = e - rr * nw;
        s_code[e] = pack4(si + (base + c0 + rr) * d, 4 * w, d);
      }
      __syncthreads();
      for (int rr = threadIdx.x; rr < rows; rr += kThreads) {
        const long long g = base + c0 + rr;
        int sq = 0;
        for (int w = 0; w < nw; ++w) sq = __dp4a(s_code[rr * nw + w], s_code[rr * nw + w], sq);
        s_sq[rr] = alive[g] > 0.f ? sq : -1;
        s_eps[rr] = __half2float(seps[g]);
      }
      __syncthreads();
      if (!active) continue;
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int rr = r0 + lane;
        const int p = static_cast<int>(base + c0 + rr);
        float lb = CUDART_INF_F;
        bool keep = false;
        if (rr < rows && s_sq[rr] >= 0) {
          int c = 0;
#pragma unroll
          for (int w = 0; w < MAXW; ++w) {
            if (w < nw) c = __dp4a(qw[w], s_code[rr * nw + w], c);
          }
          lb = coarse_lb(q2, ssc2, coef, qe, c, s_sq[rr], s_eps[rr]);
          keep = lb <= th;
        }
        const float tail_lb = my_lb[mp - 1];
        const int tail_pos = my_pos[mp - 1];
        unsigned hits = __ballot_sync(kFull, keep && before(lb, p, tail_lb, tail_pos));
        while (hits) {  // warp-uniform: lanes in ascending position order
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          run_insert(my_lb, my_pos, mp, __shfl_sync(kFull, lb, src), __shfl_sync(kFull, p, src),
                     lane);
        }
      }
    }
  }
  if (!active) return;
  __syncwarp();
  for (int j = lane; j < mp; j += 32) {
    const float l = my_lb[j];
    out_lb[row * mp + j] = l;
    out_pos[row * mp + j] = isfinite(l) ? my_pos[j] : -1;
  }
}

// The general kernel: any d, any mp (see the header). run_lb / run_pos hold
// two buffers of mp entries per query row (the wide run's ping-pong pair).
__global__ void __launch_bounds__(kThreads)
quant_coarse_general(const int8_t* __restrict__ qi, const float* __restrict__ qscale,
                     const float* __restrict__ qeps, const float* __restrict__ theta,
                     const int8_t* __restrict__ si, const float* __restrict__ sscale,
                     const __half* __restrict__ seps, const float* __restrict__ alive,
                     const int* __restrict__ sched, const int* __restrict__ counts,
                     float* __restrict__ out_lb, int* __restrict__ out_pos,
                     float* __restrict__ run_lb, int* __restrict__ run_pos, int n_r, int n_s,
                     int d, int mp, int bm, int bn, int max_visits) {
  __shared__ int q_w[kWarps][kWC];
  __shared__ int s_w[kRC][kWC + 1];
  __shared__ int s_sq[kRC];  // -1 marks a dead row
  __shared__ float s_eps[kRC];
  __shared__ float buf_d[kWarps][kCap];
  __shared__ int buf_p[kWarps][kCap];

  const int nw = (d + 3) >> 2;  // packed words per row
  const int tile_r = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_local = blockIdx.x * kWarps + warp;
  const long long row = static_cast<long long>(tile_r) * bm + q_local;
  const bool active = q_local < bm && row < n_r;  // uniform across the warp
  const int ns_tiles = n_s / bn;

  float qsc = 1.f, qe = 0.f, th = -CUDART_INF_F;
  int qa = 0;  // Σ qcode², exact in any order
  if (active) {
    qsc = qscale[row];
    qe = qeps[row];
    th = theta[row];
    for (int w = lane; w < nw; w += 32) {
      const int word = pack4(qi + row * d, 4 * w, d);
      qa = __dp4a(word, word, qa);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qa += __shfl_xor_sync(kFull, qa, off);
  const float q2 = __fmul_rn(__fmul_rn(qsc, qsc), static_cast<float>(qa));

  repro_torch::WideRun<kCap> run;
  if (active) {
    float* rl = run_lb + row * 2LL * mp;
    int* rp = run_pos + row * 2LL * mp;
    run.init(rl, rp, rl + mp, rp + mp, buf_d[warp], buf_p[warp], mp);
  }

  const int cnt = min(counts[tile_r], max_visits);
  const int* srow = sched + static_cast<size_t>(tile_r) * max_visits;
  for (int v = 0; v < cnt; ++v) {
    const int t = srow[v];
    if (t < 0 || t >= ns_tiles) continue;  // nothing to read (block-uniform)
    const float ssc = sscale[t];
    const float ssc2 = __fmul_rn(ssc, ssc);
    const float coef = __fmul_rn(2.f, __fmul_rn(qsc, ssc));
    const long long base = static_cast<long long>(t) * bn;
    for (int c0 = 0; c0 < bn; c0 += kRC) {
      const int rows = min(kRC, bn - c0);
      int acc0 = 0, acc1 = 0, sq = 0;
      for (int w0 = 0; w0 < nw; w0 += kWC) {
        const int wk = min(kWC, nw - w0);
        __syncthreads();  // the previous chunk (and selection) is consumed
        for (int e = tid; e < kWarps * kWC; e += kThreads) {
          const int w = e / kWC;
          const int j = e - w * kWC;
          const long long qrow = static_cast<long long>(tile_r) * bm + blockIdx.x * kWarps + w;
          const bool ok = blockIdx.x * kWarps + w < bm && qrow < n_r && j < wk;
          q_w[w][j] = ok ? pack4(qi + qrow * d, 4 * (w0 + j), d) : 0;
        }
        for (int e = tid; e < kRC * kWC; e += kThreads) {
          const int i = e / kWC;
          const int j = e - i * kWC;
          s_w[i][j] = (i < rows && j < wk) ? pack4(si + (base + c0 + i) * d, 4 * (w0 + j), d) : 0;
        }
        __syncthreads();
        if (tid < kRC) {
          for (int j = 0; j < wk; ++j) sq = __dp4a(s_w[tid][j], s_w[tid][j], sq);
        }
        for (int j = 0; j < wk; ++j) {
          const int qw = q_w[warp][j];
          acc0 = __dp4a(qw, s_w[lane][j], acc0);
          acc1 = __dp4a(qw, s_w[lane + 32][j], acc1);
        }
      }
      if (tid < kRC) {
        const long long g = base + c0 + tid;
        s_sq[tid] = (tid < rows && alive[g] > 0.f) ? sq : -1;
        s_eps[tid] = tid < rows ? __half2float(seps[g]) : 0.f;
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int rr = lane + 32 * m;
          float lb = CUDART_INF_F;
          bool keep = false;
          if (s_sq[rr] >= 0) {
            lb = coarse_lb(q2, ssc2, coef, qe, m == 0 ? acc0 : acc1, s_sq[rr], s_eps[rr]);
            keep = lb <= th;
          }
          run.offer(lb, static_cast<int>(base + c0 + rr), keep);
        }
      }
    }
  }
  if (!active) return;
  run.flush();
  const float* kl = run.keys();
  const int* kp = run.positions();
  for (int j = lane; j < mp; j += 32) {
    const float l = kl[j];
    out_lb[row * mp + j] = l;
    out_pos[row * mp + j] = isfinite(l) ? kp[j] : -1;
  }
}

template <int MAXW>
cudaError_t launch(const int8_t* qi, const float* qscale, const float* qeps, const float* theta,
                   const int8_t* si, const float* sscale, const __half* seps, const float* alive,
                   const int* sched, const int* counts, float* out_lb, int* out_pos, int n_r,
                   int n_s, int d, int mp, int bm, int bn, int nr_tiles, int max_visits,
                   cudaStream_t stream) {
  const int nw = (d + 3) >> 2;
  const int run_bytes = 2 * kWarps * mp * 4;
  const int row_bytes = 4 * nw + 8;
  const int chunk = std::min(bn, (kSmemBytes - run_bytes) / row_bytes);
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(run_bytes) + static_cast<size_t>(chunk) * row_bytes;
  const dim3 grid((bm + kWarps - 1) / kWarps, nr_tiles);
  quant_coarse_kernel<MAXW><<<grid, kThreads, smem, stream>>>(
      qi, qscale, qeps, theta, si, sscale, seps, alive, sched, counts, out_lb, out_pos, n_r, n_s,
      d, mp, bm, bn, max_visits, chunk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for shapes the
// kernel does not take: d >= 1, mp a power of two, S tile-padded to a
// multiple of bn). d <= 128 with mp <= 512 runs the register kernel; past
// either the general kernel, whose wide runs live in run_lb / run_pos
// (n_r x 2mp entries each; unused, and may be null, otherwise).
extern "C" int repro_quant_coarse(const void* qi, const void* qscale, const void* qeps,
                                  const void* theta, const void* si, const void* sscale,
                                  const void* seps, const void* alive, const void* sched,
                                  const void* counts, void* out_lb, void* out_pos, void* run_lb,
                                  void* run_pos, int n_r, int n_s, int d, int mp, int bm, int bn,
                                  int nr_tiles, int max_visits, void* stream) {
  if (d < 1 || mp < 1 || (mp & (mp - 1)) != 0 || bm < 1 || bn < 1 || n_s < bn ||
      n_s % bn != 0 || max_visits < 1 || n_r < 1 || nr_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a_qi = static_cast<const int8_t*>(qi);
  const auto* a_qsc = static_cast<const float*>(qscale);
  const auto* a_qe = static_cast<const float*>(qeps);
  const auto* a_th = static_cast<const float*>(theta);
  const auto* a_si = static_cast<const int8_t*>(si);
  const auto* a_ssc = static_cast<const float*>(sscale);
  const auto* a_se = static_cast<const __half*>(seps);
  const auto* a_al = static_cast<const float*>(alive);
  const auto* a_sc = static_cast<const int*>(sched);
  const auto* a_cn = static_cast<const int*>(counts);
  auto* o_lb = static_cast<float*>(out_lb);
  auto* o_pos = static_cast<int*>(out_pos);
  auto st = static_cast<cudaStream_t>(stream);
  if (d > 128 || mp > 512) {
    if (run_lb == nullptr || run_pos == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((bm + kWarps - 1) / kWarps, nr_tiles);
    quant_coarse_general<<<grid, kThreads, 0, st>>>(
        a_qi, a_qsc, a_qe, a_th, a_si, a_ssc, a_se, a_al, a_sc, a_cn, o_lb, o_pos,
        static_cast<float*>(run_lb), static_cast<int*>(run_pos), n_r, n_s, d, mp, bm, bn,
        max_visits);
    return static_cast<int>(cudaGetLastError());
  }
  if (d <= 16)
    return static_cast<int>(launch<4>(a_qi, a_qsc, a_qe, a_th, a_si, a_ssc, a_se, a_al, a_sc, a_cn,
                                      o_lb, o_pos, n_r, n_s, d, mp, bm, bn, nr_tiles, max_visits,
                                      st));
  if (d <= 32)
    return static_cast<int>(launch<8>(a_qi, a_qsc, a_qe, a_th, a_si, a_ssc, a_se, a_al, a_sc, a_cn,
                                      o_lb, o_pos, n_r, n_s, d, mp, bm, bn, nr_tiles, max_visits,
                                      st));
  return static_cast<int>(launch<32>(a_qi, a_qsc, a_qe, a_th, a_si, a_ssc, a_se, a_al, a_sc, a_cn,
                                     o_lb, o_pos, n_r, n_s, d, mp, bm, bn, nr_tiles, max_visits,
                                     st));
}
