// Flash attention backward (K-B) for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package trains through its jnp attention
// (src/repro/models/layers.py, _sdpa) and has no Pallas backward (ROADMAP
// C9); the port runs every attention layer on K-F (flash_attn.cu), so K-F
// needs a gradient of its own: FlashAttentionFn (kernels/flash_attention.py)
// runs K-F with each row's log-sum-exp forward and this kernel backward.
//
// What it computes. The gradient of K-F's function, at K-F's semantics:
// q, o, dO (b, nq, h, d), k and v (b, nk, kvh, d), bf16 or fp32, contiguous;
// query head hq reads kv head hq / (h / kvh) (GQA); query row i sits at
// position i + nk - nq; key j is visible when j < nk, j <= the position
// (causal) and j > the position - window (a window). With lse (b, h, nq) fp32
// from K-F's forward, in fp32 throughout (FlashAttention-2's backward):
//   D_i = Σ_c dO[i, c]·o[i, c]                         (bwd_dsum)
//   s = (q · k)·scale,  p = exp(s - lse) (0 where masked: a row that sees no
//   key has lse = -inf and gets 0, never NaN),  dP = dO · vᵀ,
//   dS = p ∘ (dP - D)
// With the logit softcap (cap > 0; a compile-time variant of every kernel, so
// the uncapped instances are unchanged) s is the capped logit cap·tanh(s/cap),
// as K-F's forward took it (IEEE tanhf), and dS gains the cap's derivative:
//   dS = p ∘ (dP - D) ∘ (1 - tanh²(s/cap)).
//   dv = Σ_i pᵀ dO,  dk = (Σ_i dSᵀ q)·scale           (the dk/dv pass)
//   dq = (Σ_j dS k)·scale                              (the dq pass)
// written in the inputs' type. No atomics: every output element is summed in
// an order fixed by the shapes alone, so the gradient is deterministic and a
// checkpoint restart is bitwise on the card. Rows are the "virtual rows" of
// K-F: the (q head of the kv head's group, query) pairs, so one K/V tile
// serves the whole group. Two routes, chosen by the wrapper's plan
// (kernels/flash_attention.py, plan_attention_bwd) from the dtype:
//
// mma — bf16 (training at full width), d <= 256. The work is 2·(3d + 2d)
//   operations per visible (query, key, head) pair, hundreds per byte, so
//   it is bound by operations at the bf16 tensor cores' 989 TFLOP/s. Every
//   product runs on them with mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
//   as K-F's forward does (its notes say why mma.sync and not wgmma).
//   - bwd_dkdv_mma, FlashAttention-2's transposed form: a block owns 64 keys
//     of one (batch, kv head), 16 a key group of warps, and walks every
//     visible step of 32 virtual rows. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with keys as
//     the M dimension (a bf16 × bf16 product is exact in fp32, so these are
//     the upcast dot products up to the order of their sums); pᵀ and dSᵀ are
//     made in the accumulator fragments (lse and D are per-column values)
//     and are the A operand of dV += pᵀ·dO and dK += dSᵀ·Q; dO and Q are the
//     B operands through ldmatrix.trans. Q, dO, lse and D of the next step
//     are staged by cp.async into a double buffer while this step is
//     computed. Up to d = 64 a warp is a key group and its fragments go from
//     its accumulators to its A operands without touching shared memory. A
//     warp's 16 keys × d of dK and dV take d fp32 registers a thread, so
//     from d = 128 two warps share a key group: each makes the fragments of
//     16 of the step's 32 rows, the pair swaps them through shared memory in
//     fragment order (16 KB a step), and each accumulates half of d's
//     columns (the logits are computed once). At d = 128 one warp a group
//     took 255 registers and spilled; the pair ran 9 % faster, the same bits.
//   - Row splits where the grid is thin: when (key tiles) × b × kvh is below
//     3 a SM (396 blocks), the plan cuts each group's row steps into s
//     interleaved parts, s enough to reach 396 (part z takes steps z, z + s,
//     ...; MQA: recurrentgemma's kvh = 1 gets 7); each part writes fp32
//     partial dK, dV to a scratch the wrapper allocates, and
//     bwd_dkdv_reduce sums the s partials in order and rounds once. Of 3 to
//     17 parts at recurrentgemma's shapes, 7 to 13 ran fastest.
//   - Block order: under a causal mask or a window a dk/dv block's work falls
//     with its key tile, so the 1-D grid starts every group's first key tiles
//     first (12 % and 21 % off recurrentgemma's and MLA's times); without a
//     mask the blocks of one group run side by side and share its rows in L2
//     (whisper's encoder ran 25 % slower in tile order).
//   - bwd_dq_mma: a block owns 64 virtual rows (4 warps of 16; 128, 8 warps,
//     at d = 256; every group's long causal rows first), recomputes S and dP
//     over every visible key tile (64 keys; 32 past d = 128, for registers),
//     K and V tiles double-buffered by cp.async, and accumulates dQ += dS·K
//     from dS's fragments as K-F does P·V. Two passes, not one with dq through an fp32 scratch: at
//     llama's shape that scratch would move ~0.43 GB (0.26 ms at 3.35 TB/s)
//     to save a recompute of S and dP worth ~0.026 ms at the bf16 peak, and
//     ordered atomics would break determinism.
//   - p and dS are fp32 and enter the bf16 MMAs as two bf16 terms, hi =
//     bf16(x) and lo = bf16(x - hi) (x - hi is exact; hi + lo is x within
//     2^-17 relative), lo's product first. One term (SDPA's choice) rounds
//     them to 2^-9; three (K-F's exact split) cost another 6d operations a
//     pair for bits the bf16 outputs round away: per pair at d = 128 the two
//     passes do 20d operations with two terms (14d / 26d with one / three).
//   - Accumulation: the tensor cores' fp32 additions are not IEEE
//     round-to-nearest, so no accumulator of dK, dV or dQ runs longer than
//     one step: each step's product (a chain of 2 × (rows or keys) / 16
//     k-steps, from 0) is added to the running sum with an IEEE add, as K-F
//     adds each tile's p·V; the logits' chains are d / 16 k-steps long.
//     Accumulating across steps in the tensor cores ran 3-5 % faster and
//     moved dk and dv by 2.4e-4 of their norm at recurrentgemma's 32,768
//     rows a key (this form is 1.0e-4 from the plain version there).
//   - d is padded to the instantiated width DP (32, 64, 128, 192, 256) with
//     zeros; the wrapper pads the row width d to a multiple of 8 (16-byte
//     cp.async chunks). Rows past the group, keys past nk and columns past d
//     are zero-filled and masked; padded v / dO columns give dv exactly 0.
//
// simt — fp32 (the reduced model's card-vs-CPU path and the bitwise restart's
//   path), the first form of this kernel, kept bit for bit: fp32 FMAs on CUDA
//   cores (67 TFLOP/s fp32 is its ceiling), each output element summed by one
//   thread.
//   - bwd_dkdv: one block per (batch, kv head, tile of 32 keys). It keeps its
//     K and V tile in shared memory and dK, dV for its 32 keys in registers,
//     and walks every tile of 32 virtual rows that can see its keys (tiles no
//     row of which sees a key of the block are skipped): stage q, dO, lse, D;
//     S and dP (32 x 32, a 2 x 2 register tile a thread); p and dS to shared
//     memory; dV += pᵀ dO and dK += dSᵀ q (4 keys x d/32 columns a thread).
//   - bwd_dq: one block per (batch, kv head, tile of 32 virtual rows), dQ in
//     registers, over every key tile its rows can see.
//   Tiles are staged as fp32 with an odd row stride (no bank conflicts on the
//   column reads); d is padded to the instantiated width DP (32, 64, 128,
//   192, 256) with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (b, h, nq)
  float* dsum;       // (b, h, nq): D, written by bwd_dsum
  void* dq;
  void* dk;
  void* dv;
  float* part;  // mma route with splits > 1: fp32 partial dK, dV (2, splits, b, nk, kvh, d)
  int b, nq, nk, h, kvh, d;
  int causal, use_window, window;
  float scale;
  float softcap;  // > 0: the capped instances run
  int splits;   // mma route: interleaved parts of each group's row steps in the dk/dv pass
};

constexpr int kThreads = 256;
constexpr int kBR = 32;       // virtual rows per tile
constexpr int kBC = 32;       // keys per tile
constexpr int kPS = kBC + 1;  // row stride of the p / dS tiles

// The logit p is taken from: the scaled logit x, capped to cap·tanh(x / cap)
// in the CAP instances, and the factor the cap puts on dS (1 - tanh²).
template <bool CAP>
__device__ __forceinline__ float capped(float x, float cap, float* fac) {
  if constexpr (CAP) {
    const float t = tanhf(x / cap);
    *fac = 1.f - t * t;
    return t * cap;
  } else {
    return x;
  }
}

__device__ __forceinline__ bool visible(const Args& a, int key, int qpos) {
  bool mk = key < a.nk;
  if (a.causal) mk = mk && key <= qpos;
  if (a.use_window) mk = mk && key > qpos - a.window;
  return mk;
}

// Does any row of positions [first_q, last_q] see a key of [k0, k1]?
__device__ __forceinline__ bool tile_relevant(const Args& a, int k0, int k1, int first_q,
                                              int last_q) {
  bool rel = true;
  if (a.causal) rel = rel && k0 <= last_q;
  if (a.use_window) rel = rel && k1 > first_q - a.window;
  return rel;
}

// The range of query positions of virtual rows v0..v1-1 (they may span heads).
__device__ __forceinline__ void row_positions(const Args& a, int v0, int v1, int* first_q,
                                              int* last_q) {
  int lo_i, hi_i;
  if (v0 / a.nq == (v1 - 1) / a.nq) {
    lo_i = v0 % a.nq;
    hi_i = (v1 - 1) % a.nq;
  } else {
    lo_i = 0;
    hi_i = a.nq - 1;
  }
  *first_q = lo_i + a.nk - a.nq;
  *last_q = hi_i + a.nk - a.nq;
}

// Offset of virtual row vr of kv head g, batch row bb, in a (b, nq, h, d)
// tensor, and in a (b, h, nq) one.
__device__ __forceinline__ long long row_off(const Args& a, long long bb, int g, int vr) {
  const int rep = a.h / a.kvh;
  const int hh = vr / a.nq;
  const int i = vr - hh * a.nq;
  return ((bb * a.nq + i) * a.h + g * rep + hh) * static_cast<long long>(a.d);
}
__device__ __forceinline__ long long stat_off(const Args& a, long long bb, int g, int vr) {
  const int rep = a.h / a.kvh;
  const int hh = vr / a.nq;
  return (bb * a.h + g * rep + hh) * static_cast<long long>(a.nq) + (vr - hh * a.nq);
}

// Stage 32 virtual rows (from v0) of a (b, nq, h, d) tensor as fp32 into dst
// (row stride DP + 1); rows at or past nv and columns at or past d are 0.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, const Args& a, long long bb,
                                           int g, int v0, int nv, int tid) {
  for (int e = tid; e < kBR * DP; e += kThreads) {
    const int r = e / DP;
    const int c = e - r * DP;
    const int vr = v0 + r;
    dst[r * (DP + 1) + c] = (vr < nv && c < a.d) ? to_f(src[row_off(a, bb, g, vr) + c]) : 0.f;
  }
}

// Stage 32 keys (from k0) of kv head g of a (b, nk, kvh, d) tensor.
template <typename T, int DP>
__device__ __forceinline__ void stage_keys(float* dst, const T* src, const Args& a, long long bb,
                                           int g, int k0, int tid) {
  for (int e = tid; e < kBC * DP; e += kThreads) {
    const int r = e / DP;
    const int c = e - r * DP;
    const int key = k0 + r;
    dst[r * (DP + 1) + c] =
        (key < a.nk && c < a.d)
            ? to_f(src[((bb * a.nk + key) * a.kvh + g) * static_cast<long long>(a.d) + c])
            : 0.f;
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * static_cast<size_t>(kBR) * (DP + 1) + 2 * kBR * kPS + 2 * kBR);
}

// S = q·kᵀ and dP = dO·vᵀ for a 32 x 32 tile, then p and dS into p_s / ds_s.
// Thread (ty, tx): rows ty + 16r, keys tx + 16c (r, c < 2).
template <int DP, bool CAP>
__device__ __forceinline__ void tile_p_ds(const Args& a, const float* q_s, const float* g_s,
                                          const float* k_s, const float* v_s,
                                          const float* lse_s, const float* dsum_s, float* p_s,
                                          float* ds_s, int v0, int nv, int k0, int tid) {
  constexpr int S = DP + 1;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float pa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int j = 0; j < a.d; ++j) {
    const float q0 = q_s[ty * S + j], q1 = q_s[(ty + 16) * S + j];
    const float g0 = g_s[ty * S + j], g1 = g_s[(ty + 16) * S + j];
    const float k0v = k_s[tx * S + j], k1v = k_s[(tx + 16) * S + j];
    const float v0v = v_s[tx * S + j], v1v = v_s[(tx + 16) * S + j];
    sa[0][0] = fmaf(q0, k0v, sa[0][0]);
    sa[0][1] = fmaf(q0, k1v, sa[0][1]);
    sa[1][0] = fmaf(q1, k0v, sa[1][0]);
    sa[1][1] = fmaf(q1, k1v, sa[1][1]);
    pa[0][0] = fmaf(g0, v0v, pa[0][0]);
    pa[0][1] = fmaf(g0, v1v, pa[0][1]);
    pa[1][0] = fmaf(g1, v0v, pa[1][0]);
    pa[1][1] = fmaf(g1, v1v, pa[1][1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ty + 16 * r;
    const int vr = v0 + row;
    const int qpos = vr < nv ? (vr % a.nq) + a.nk - a.nq : 0;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = tx + 16 * c;
      const bool mk = vr < nv && visible(a, k0 + col, qpos);
      float fac;
      const float p = mk ? expf(capped<CAP>(sa[r][c] * a.scale, a.softcap, &fac) - lse_s[row])
                         : 0.f;
      p_s[row * kPS + col] = p;
      if constexpr (CAP) {
        ds_s[row * kPS + col] = mk ? p * (pa[r][c] - dsum_s[row]) * fac : 0.f;
      } else {
        ds_s[row * kPS + col] = p * (pa[r][c] - dsum_s[row]);
      }
    }
  }
}

// ------------------------------------------------------------ bwd_dsum

// D of each row, one warp a row (rows in (b, nq, h) order).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dsum(const Args a) {
  const long long n_rows = static_cast<long long>(a.b) * a.nq * a.h;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(a.o) + row * a.d;
  const T* g = static_cast<const T*>(a.dout) + row * a.d;
  float acc = 0.f;
  for (int c = lane; c < a.d; c += 32) acc = fmaf(to_f(g[c]), to_f(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long hq = row % a.h;
    const long long bi = row / a.h;  // bb·nq + i
    a.dsum[((bi / a.nq) * a.h + hq) * a.nq + bi % a.nq] = acc;
  }
}

// ------------------------------------------------------------ bwd_dkdv

template <typename T, int DP, bool CAP>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(const Args a) {
  constexpr int S = DP + 1;
  constexpr int CPT = DP / 32;  // columns a thread in the accumulation
  extern __shared__ float smem[];
  float* k_s = smem;                // 32 x S
  float* v_s = k_s + kBC * S;       // 32 x S
  float* q_s = v_s + kBC * S;       // 32 x S
  float* g_s = q_s + kBR * S;       // 32 x S (dO)
  float* p_s = g_s + kBR * S;       // 32 x kPS
  float* ds_s = p_s + kBR * kPS;    // 32 x kPS
  float* lse_s = ds_s + kBR * kPS;  // 32
  float* dsum_s = lse_s + kBR;      // 32

  const int tid = threadIdx.x;
  const int g = blockIdx.y % a.kvh;
  const long long bb = blockIdx.y / a.kvh;
  const int k0 = blockIdx.x * kBC;
  const int nv = (a.h / a.kvh) * a.nq;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  stage_keys<T, DP>(k_s, static_cast<const T*>(a.k), a, bb, g, k0, tid);
  stage_keys<T, DP>(v_s, static_cast<const T*>(a.v), a, bb, g, k0, tid);

  float acck[4][CPT], accv[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acck[r][c] = accv[r][c] = 0.f;

  for (int v0 = 0; v0 < nv; v0 += kBR) {
    int first_q, last_q;
    row_positions(a, v0, min(v0 + kBR, nv), &first_q, &last_q);
    if (!tile_relevant(a, k0, k0 + kBC - 1, first_q, last_q)) continue;  // block-uniform
    __syncthreads();  // q_s, g_s, lse_s, dsum_s are free
    stage_rows<T, DP>(q_s, static_cast<const T*>(a.q), a, bb, g, v0, nv, tid);
    stage_rows<T, DP>(g_s, static_cast<const T*>(a.dout), a, bb, g, v0, nv, tid);
    if (tid < kBR) {
      const int vr = v0 + tid;
      lse_s[tid] = vr < nv ? a.lse[stat_off(a, bb, g, vr)] : 0.f;
      dsum_s[tid] = vr < nv ? a.dsum[stat_off(a, bb, g, vr)] : 0.f;
    }
    __syncthreads();
    tile_p_ds<DP, CAP>(a, q_s, g_s, k_s, v_s, lse_s, dsum_s, p_s, ds_s, v0, nv, k0, tid);
    __syncthreads();
    // dV += pᵀ dO, dK += dSᵀ q: keys warp + 8r, columns lane + 32c
    const int rows = min(kBR, nv - v0);
    for (int row = 0; row < rows; ++row) {
      float pk[4], dsk[4], gv[CPT], qv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pk[r] = p_s[row * kPS + warp + 8 * r];
        dsk[r] = ds_s[row * kPS + warp + 8 * r];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        gv[c] = g_s[row * S + lane + 32 * c];
        qv[c] = q_s[row * S + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          accv[r][c] = fmaf(pk[r], gv[c], accv[r][c]);
          acck[r][c] = fmaf(dsk[r], qv[c], acck[r][c]);
        }
    }
  }

  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + warp + 8 * r;
    if (key >= a.nk) continue;
    const long long off = ((bb * a.nk + key) * a.kvh + g) * static_cast<long long>(a.d);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      if (col < a.d) {
        dk[off + col] = from_f<T>(acck[r][c] * a.scale);
        dv[off + col] = from_f<T>(accv[r][c]);
      }
    }
  }
}

// ------------------------------------------------------------ bwd_dq

template <typename T, int DP, bool CAP>
__global__ void __launch_bounds__(kThreads) bwd_dq(const Args a) {
  constexpr int S = DP + 1;
  constexpr int CPT = DP / 32;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBC * S;
  float* q_s = v_s + kBC * S;
  float* g_s = q_s + kBR * S;
  float* p_s = g_s + kBR * S;
  float* ds_s = p_s + kBR * kPS;
  float* lse_s = ds_s + kBR * kPS;
  float* dsum_s = lse_s + kBR;

  const int tid = threadIdx.x;
  const int g = blockIdx.y % a.kvh;
  const long long bb = blockIdx.y / a.kvh;
  const int nv = (a.h / a.kvh) * a.nq;
  const int v0 = blockIdx.x * kBR;
  const int v1 = min(v0 + kBR, nv);
  const int warp = tid >> 5;
  const int lane = tid & 31;

  stage_rows<T, DP>(q_s, static_cast<const T*>(a.q), a, bb, g, v0, nv, tid);
  stage_rows<T, DP>(g_s, static_cast<const T*>(a.dout), a, bb, g, v0, nv, tid);
  if (tid < kBR) {
    const int vr = v0 + tid;
    lse_s[tid] = vr < nv ? a.lse[stat_off(a, bb, g, vr)] : 0.f;
    dsum_s[tid] = vr < nv ? a.dsum[stat_off(a, bb, g, vr)] : 0.f;
  }
  int first_q, last_q;
  row_positions(a, v0, v1, &first_q, &last_q);

  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < a.nk; k0 += kBC) {
    if (!tile_relevant(a, k0, k0 + kBC - 1, first_q, last_q)) continue;  // block-uniform
    __syncthreads();  // k_s, v_s, ds_s are free
    stage_keys<T, DP>(k_s, static_cast<const T*>(a.k), a, bb, g, k0, tid);
    stage_keys<T, DP>(v_s, static_cast<const T*>(a.v), a, bb, g, k0, tid);
    __syncthreads();
    tile_p_ds<DP, CAP>(a, q_s, g_s, k_s, v_s, lse_s, dsum_s, p_s, ds_s, v0, nv, k0, tid);
    __syncthreads();
    // dQ += dS k: rows warp + 8r, columns lane + 32c
    const int keys = min(kBC, a.nk - k0);
    for (int key = 0; key < keys; ++key) {
      float dsv[4], kv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = ds_s[(warp + 8 * r) * kPS + key];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = k_s[key * S + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int vr = v0 + warp + 8 * r;
    if (vr >= nv) continue;
    const long long off = row_off(a, bb, g, vr);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      if (col < a.d) dq[off + col] = from_f<T>(acc[r][c] * a.scale);
    }
  }
}

// ------------------------------------------------------------ mma route (bf16)

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

constexpr int kKvKeys = 64;  // keys a bwd_dkdv_mma block owns (4 key groups of 16)
constexpr int kKvRows = 32;  // virtual rows of one of its steps

// Warps sharing one key group of bwd_dkdv_mma: 1 up to d = 64 (a warp keeps
// 16 keys x DP of dK and of dV, DP fp32 registers a thread), 2 from d = 128
// (each keeps half of DP's columns; at d = 128 one warp would take 255
// registers and spill, and ran 9 % slower).
template <int DP>
__host__ __device__ constexpr int kv_group_warps() { return DP >= 128 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int dq_keys() { return DP > 128 ? 32 : 64; }
// warps of a bwd_dq_mma block, 16 virtual rows each: 8 at d = 256 (one block
// of 4 fills an SM's shared memory there; 8 ran 14 % faster), else 4
template <int DP>
__host__ __device__ constexpr int dq_warps() { return DP > 192 ? 8 : 4; }

template <int DP>
constexpr size_t kv_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * kKvKeys + 4 * kKvRows) * (DP + 8) +
         sizeof(float) * 4 * kKvRows +
         (kv_group_warps<DP>() > 1 ? sizeof(uint4) * 2 * 4 * (kKvRows / 16) * 2 * 32 : 0);
}
template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * 16 * dq_warps<DP>() + 4 * dq_keys<DP>()) * (DP + 8);
}

// Stage ROWS virtual rows (from v0) of a (b, nq, h, d) bf16 tensor into dst
// (row stride DP + 8) by cp.async; rows at or past nv and columns at or past
// d are zero-filled.
template <int ROWS, int DP, int NTH>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src, const Args& a,
                                                 long long bb, int g, int v0, int nv, int tid) {
  constexpr int CH = DP / 8;
#pragma unroll 4
  for (int e = tid; e < ROWS * CH; e += NTH) {
    const int r = e / CH;
    const int c = (e - r * CH) * 8;
    const int vr = v0 + r;
    const bool ok = vr < nv && c < a.d;
    cp_async16(dst + r * (DP + 8) + c, ok ? src + row_off(a, bb, g, vr) + c : src, ok ? 16 : 0);
  }
}

// Stage ROWS keys (from k0) of kv head g of a (b, nk, kvh, d) bf16 tensor.
template <int ROWS, int DP, int NTH>
__device__ __forceinline__ void stage_keys_async(bf16* dst, const bf16* src, const Args& a,
                                                 long long bb, int g, int k0, int tid) {
  constexpr int CH = DP / 8;
#pragma unroll 4
  for (int e = tid; e < ROWS * CH; e += NTH) {
    const int r = e / CH;
    const int c = (e - r * CH) * 8;
    const int key = k0 + r;
    const bool ok = key < a.nk && c < a.d;
    cp_async16(dst + r * (DP + 8) + c,
               ok ? src + ((bb * a.nk + key) * a.kvh + g) * static_cast<long long>(a.d) + c : src,
               ok ? 16 : 0);
  }
}

// C[n] += A·Bᵀ over DP columns for n < NT: A the 16 rows of `as`, B the NT·8
// rows of `bs` (both row-major, stride DP + 8), one chain of DP / 16 k-steps.
template <int NT, int DP>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* as, const bf16* bs,
                                        int lane) {
  constexpr int S = DP + 8;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];  // rows 0-7 / 8-15 at columns 0-7, then at 8-15
    ldmatrix_x4(a, as + ((lane & 7) + (mi & 1) * 8) * S + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, bs + ((n + (mi >> 1)) * 8 + (lane & 7)) * S + kk * 16 + (mi & 1) * 8);
      mma_bf16(c[n], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(c[n + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
}

// The A fragments of x (accumulators of NT n-tiles: k-step kk is n-tiles 2kk
// and 2kk + 1) as two bf16 terms, f[0] = hi = bf16(x), f[1] = lo = bf16(x - hi).
template <int NT>
__device__ __forceinline__ void split_frags(uint32_t (&f)[2][NT / 2][4], const float (&x)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[2 * kk + (r >> 1)][2 * (r & 1)];
      const float x1 = x[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
      f[0][kk][r] = pack2(h0, h1);
      f[1][kk][r] = pack2(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                          __float2bfloat16_rn(x1 - __bfloat162float(h1)));
    }
}

// C (16 rows x NC·8 columns from col0) += Σ_term f[term]·B, B the KK·16 rows of
// `bs` (row-major, stride DP + 8) read through ldmatrix.trans. Each column
// pair's product is summed from 0 (lo terms first) and added to C once.
template <int KK, int NC, int DP>
__device__ __forceinline__ void mma_frag_b(float (&c)[NC][4], const uint32_t (&f)[2][KK][4],
                                           const bf16* bs, int col0, int lane) {
  constexpr int S = DP + 8;
  const int mi = lane >> 3;
#pragma unroll
  for (int n = 0; n < NC; n += 2) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * S + col0 + n * 8 +
                               (mi >> 1) * 8);
#pragma unroll
      for (int term = 1; term >= 0; --term) {
        const uint32_t(&fa)[4] = f[term][kk];
        mma_bf16(t0, fa[0], fa[1], fa[2], fa[3], b[0], b[1]);
        mma_bf16(t1, fa[0], fa[1], fa[2], fa[3], b[2], b[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[n][e] += t0[e];
      c[n + 1][e] += t1[e];
    }
  }
}

// ---- bwd_dkdv_mma: a 1-D grid over (key tile of 64, part, b·kvh). Under a
// causal mask or a window the key tiles are the slowest index (the first
// tiles, the longest, start first in every group); without one the group is
// (the group's tiles run side by side and share its rows in L2).
template <int DP, bool CAP>
__global__ void __launch_bounds__(128 * kv_group_warps<DP>()) bwd_dkdv_mma(const Args a) {
  constexpr int G = kv_group_warps<DP>();
  constexpr int NTH = 128 * G;
  constexpr int S = DP + 8;
  constexpr int WR = kKvRows / G;  // rows of a warp's Sᵀ
  constexpr int NT = WR / 8;
  constexpr int KW = WR / 16;      // k-steps of a warp's own fragments
  constexpr int KK = kKvRows / 16; // k-steps of a step
  constexpr int WC = DP / G;       // columns of a warp's dK and dV
  constexpr int NC = WC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);          // 64 x S
  bf16* v_s = k_s + kKvKeys * S;                          // 64 x S
  bf16* q_s = v_s + kKvKeys * S;                          // 2 x 32 x S
  bf16* g_s = q_s + 2 * kKvRows * S;                      // 2 x 32 x S (dO)
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * kKvRows * S);  // 2 x 32
  float* dsum_s = lse_s + 2 * kKvRows;                    // 2 x 32
  uint4* frag_s = reinterpret_cast<uint4*>(dsum_s + 2 * kKvRows);  // G > 1: [p, dS][kg][kk][term][lane]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int kg = warp & 3;    // key group: keys kg·16 .. kg·16 + 15 of the block
  const int grp = warp >> 2;  // rows of the step (phase A), columns (phase B)
  const long long groups = static_cast<long long>(a.b) * a.kvh;
  const int n_tiles = (a.nk + kKvKeys - 1) / kKvKeys;
  long long gi;
  int part, tile;
  if (a.causal || a.use_window) {
    gi = blockIdx.x % groups;
    part = static_cast<int>((blockIdx.x / groups) % a.splits);
    tile = static_cast<int>(blockIdx.x / groups / a.splits);
  } else {
    tile = static_cast<int>(blockIdx.x % n_tiles);
    part = static_cast<int>((blockIdx.x / n_tiles) % a.splits);
    gi = blockIdx.x / n_tiles / a.splits;
  }
  const int g = static_cast<int>(gi % a.kvh);
  const long long bb = gi / a.kvh;
  const int k0 = tile * kKvKeys;
  const int nv = (a.h / a.kvh) * a.nq;
  const int n_steps = (nv + kKvRows - 1) / kKvRows;

  auto relevant = [&](int st) {
    int first_q, last_q;
    row_positions(a, st * kKvRows, min(st * kKvRows + kKvRows, nv), &first_q, &last_q);
    return tile_relevant(a, k0, k0 + kKvKeys - 1, first_q, last_q);
  };
  auto next = [&](int st) {  // this part's first visible step from st (block-uniform)
    while (st < n_steps && !relevant(st)) st += a.splits;
    return st;
  };
  auto stage = [&](int buf, int st) {
    const int v0 = st * kKvRows;
    stage_rows_async<kKvRows, DP, NTH>(q_s + buf * kKvRows * S, q, a, bb, g, v0, nv, tid);
    stage_rows_async<kKvRows, DP, NTH>(g_s + buf * kKvRows * S, dout, a, bb, g, v0, nv, tid);
    if (tid < kKvRows) {
      const int vr = v0 + tid;
      const bool ok = vr < nv;
      const long long off = ok ? stat_off(a, bb, g, vr) : 0;
      cp_async4(lse_s + buf * kKvRows + tid, a.lse + off, ok ? 4 : 0);
      cp_async4(dsum_s + buf * kKvRows + tid, a.dsum + off, ok ? 4 : 0);
    }
  };

  stage_keys_async<kKvKeys, DP, NTH>(k_s, static_cast<const bf16*>(a.k), a, bb, g, k0, tid);
  stage_keys_async<kKvKeys, DP, NTH>(v_s, static_cast<const bf16*>(a.v), a, bb, g, k0, tid);
  int st = next(part);
  if (st < n_steps) stage(0, st);
  cp_async_commit();

  float acck[NC][4], accv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;

  const int key_a = k0 + kg * 16 + gq;  // this thread's keys: key_a and key_a + 8
  int buf = 0;
  while (st < n_steps) {
    const int sn = next(st + a.splits);
    if (sn < n_steps) {
      stage(buf ^ 1, sn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = q_s + buf * kKvRows * S;
    const bf16* gt = g_s + buf * kKvRows * S;
    const float* lse_t = lse_s + buf * kKvRows;
    const float* dsum_t = dsum_s + buf * kKvRows;
    const int v0 = st * kKvRows;

    // ---- phase A: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (16 keys x WR rows a warp), pᵀ, dSᵀ
    float sa[NT][4], da[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = da[n][e] = 0.f;
    mma_abt<NT, DP>(sa, k_s + kg * 16 * S, qt + grp * WR * S, lane);
    mma_abt<NT, DP>(da, v_s + kg * 16 * S, gt + grp * WR * S, lane);
    int first_q, last_q;
    row_positions(a, v0, min(v0 + kKvRows, nv), &first_q, &last_q);
    // a step every row of which sees every key of the block needs no mask
    const bool full = v0 + kKvRows <= nv && k0 + kKvKeys <= a.nk &&
                      (!a.causal || k0 + kKvKeys - 1 <= first_q) &&
                      (!a.use_window || k0 > last_q - a.window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // accumulator (n, c) and (n, 2 + c): keys key_a, key_a + 8
        const int row = grp * WR + n * 8 + 2 * tq + c;
        bool m0 = true, m1 = true;
        if (!full) {
          const int vr = v0 + row;
          const bool ok = vr < nv;
          const int qpos = ok ? vr % a.nq + a.nk - a.nq : 0;
          m0 = ok && visible(a, key_a, qpos);
          m1 = ok && visible(a, key_a + 8, qpos);
        }
        const float l = lse_t[row], dd = dsum_t[row];
        float f0, f1;
        const float p0 = m0 ? expf(capped<CAP>(sa[n][c] * a.scale, a.softcap, &f0) - l) : 0.f;
        const float p1 =
            m1 ? expf(capped<CAP>(sa[n][2 + c] * a.scale, a.softcap, &f1) - l) : 0.f;
        sa[n][c] = p0;
        sa[n][2 + c] = p1;
        if constexpr (CAP) {
          da[n][c] = m0 ? p0 * (da[n][c] - dd) * f0 : 0.f;
          da[n][2 + c] = m1 ? p1 * (da[n][2 + c] - dd) * f1 : 0.f;
        } else {
          da[n][c] = p0 * (da[n][c] - dd);
          da[n][2 + c] = p1 * (da[n][2 + c] - dd);
        }
      }
    uint32_t pf[2][KW][4], df[2][KW][4];
    split_frags<NT>(pf, sa);
    split_frags<NT>(df, da);

    // ---- phase B: dV += pᵀ·dO, dK += dSᵀ·Q (16 keys x WC columns a warp)
    if constexpr (G == 1) {
      mma_frag_b<KK, NC, DP>(accv, pf, gt, 0, lane);
      mma_frag_b<KK, NC, DP>(acck, df, qt, 0, lane);
    } else {
      // the warp's fragments are k-step grp of key group kg; swap them
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        frag_s[((0 * 4 + kg) * KK + grp) * 64 + term * 32 + lane] =
            make_uint4(pf[term][0][0], pf[term][0][1], pf[term][0][2], pf[term][0][3]);
        frag_s[((1 * 4 + kg) * KK + grp) * 64 + term * 32 + lane] =
            make_uint4(df[term][0][0], df[term][0][1], df[term][0][2], df[term][0][3]);
      }
      __syncthreads();
      uint32_t pa[2][KK][4], dsa[2][KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int term = 0; term < 2; ++term) {
          const uint4 x = frag_s[((0 * 4 + kg) * KK + kk) * 64 + term * 32 + lane];
          const uint4 y = frag_s[((1 * 4 + kg) * KK + kk) * 64 + term * 32 + lane];
          pa[term][kk][0] = x.x;
          pa[term][kk][1] = x.y;
          pa[term][kk][2] = x.z;
          pa[term][kk][3] = x.w;
          dsa[term][kk][0] = y.x;
          dsa[term][kk][1] = y.y;
          dsa[term][kk][2] = y.z;
          dsa[term][kk][3] = y.w;
        }
      mma_frag_b<KK, NC, DP>(accv, pa, gt, grp * WC, lane);
      mma_frag_b<KK, NC, DP>(acck, dsa, qt, grp * WC, lane);
    }
    __syncthreads();  // this buffer (and frag_s) is consumed before it is refilled
    st = sn;
    buf ^= 1;
  }
  cp_async_wait<0>();  // nothing left in flight (a part with no visible step loaded only K, V)

  // ---- accumulator (n, e): key key_a + 8·(e >> 1), column grp·WC + n·8 + 2·tq + (e & 1)
  const long long n_el = static_cast<long long>(a.b) * a.nk * a.kvh * a.d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_a + 8 * half;
    if (key >= a.nk) continue;
    const long long off = ((bb * a.nk + key) * a.kvh + g) * static_cast<long long>(a.d);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = grp * WC + n * 8 + 2 * tq;
      if (col >= a.d) continue;
      const float k0v = acck[n][2 * half], k1v = acck[n][2 * half + 1];
      const float v0v = accv[n][2 * half], v1v = accv[n][2 * half + 1];
      if (a.splits == 1) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + off + col) =
            pack2(__float2bfloat16_rn(k0v * a.scale), __float2bfloat16_rn(k1v * a.scale));
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + off + col) =
            pack2(__float2bfloat16_rn(v0v), __float2bfloat16_rn(v1v));
      } else {
        float* pk = a.part + part * n_el + off + col;
        float* pv = pk + a.splits * n_el;
        *reinterpret_cast<float2*>(pk) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(pv) = make_float2(v0v, v1v);
      }
    }
  }
}

// ---- bwd_dkdv_reduce: dk = bf16((Σ_z part_dk[z])·scale), dv = bf16(Σ_z part_dv[z]),
// z = 0, 1, ..., splits - 1 in order (one thread an element)
__global__ void __launch_bounds__(kThreads) bwd_dkdv_reduce(const Args a) {
  const long long n_el = static_cast<long long>(a.b) * a.nk * a.kvh * a.d;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_el) return;
  float sk = 0.f, sv = 0.f;
  for (int z = 0; z < a.splits; ++z) {
    sk += a.part[z * n_el + e];
    sv += a.part[(a.splits + z) * n_el + e];
  }
  static_cast<bf16*>(a.dk)[e] = __float2bfloat16_rn(sk * a.scale);
  static_cast<bf16*>(a.dv)[e] = __float2bfloat16_rn(sv);
}

// ---- bwd_dq_mma: a 1-D grid of (row tile of 64, b·kvh), the last fastest
template <int DP, bool CAP>
__global__ void __launch_bounds__(32 * dq_warps<DP>()) bwd_dq_mma(const Args a) {
  constexpr int kDqRows = 16 * dq_warps<DP>();
  constexpr int kDqThreads = 32 * dq_warps<DP>();
  constexpr int BC = dq_keys<DP>();
  constexpr int S = DP + 8;
  constexpr int NT = BC / 8;  // n-tiles of S
  constexpr int NO = DP / 8;  // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // rows x S
  bf16* g_s = q_s + kDqRows * S;                  // rows x S (dO)
  bf16* k_s = g_s + kDqRows * S;                  // 2 x BC x S
  bf16* v_s = k_s + 2 * BC * S;                   // 2 x BC x S

  const bf16* kp = static_cast<const bf16*>(a.k);
  const bf16* vp = static_cast<const bf16*>(a.v);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int nq = a.nq, nk = a.nk;
  const int rep = a.h / a.kvh;
  const long long groups = static_cast<long long>(a.b) * a.kvh;
  const int g = static_cast<int>((blockIdx.x % groups) % a.kvh);
  const long long bb = (blockIdx.x % groups) / a.kvh;
  const int nv = rep * nq;
  // the long causal rows first: with whole tiles a head, every group's last
  // tiles of every head, then the ones before; else the tiles last-first
  const int rank = static_cast<int>(blockIdx.x / groups);
  const int n_rt = (nv + kDqRows - 1) / kDqRows;
  int rt;
  if (nq % kDqRows == 0) {
    const int per = nq / kDqRows;
    rt = (rank % rep) * per + per - 1 - rank / rep;
  } else {
    rt = n_rt - 1 - rank;
  }
  const int v0 = rt * kDqRows;
  const int v1 = min(v0 + kDqRows, nv);

  int first_q, last_q;
  row_positions(a, v0, v1, &first_q, &last_q);
  const int n_tiles = (nk + BC - 1) / BC;
  int t_lo = 0, t_hi = n_tiles - 1;
  while (t_lo <= t_hi && !tile_relevant(a, t_lo * BC, t_lo * BC + BC - 1, first_q, last_q))
    ++t_lo;
  while (t_hi >= t_lo && !tile_relevant(a, t_hi * BC, t_hi * BC + BC - 1, first_q, last_q))
    --t_hi;

  stage_rows_async<kDqRows, DP, kDqThreads>(q_s, static_cast<const bf16*>(a.q), a, bb, g, v0, nv,
                                            tid);
  stage_rows_async<kDqRows, DP, kDqThreads>(g_s, static_cast<const bf16*>(a.dout), a, bb, g, v0,
                                            nv, tid);
  if (t_lo <= t_hi) {
    stage_keys_async<BC, DP, kDqThreads>(k_s, kp, a, bb, g, t_lo * BC, tid);
    stage_keys_async<BC, DP, kDqThreads>(v_s, vp, a, bb, g, t_lo * BC, tid);
  }
  cp_async_commit();

  // this thread's two rows (gq and gq + 8 of the warp's 16)
  const int vr0 = v0 + warp * 16 + gq;
  const int vr1 = vr0 + 8;
  const bool ok0 = vr0 < nv, ok1 = vr1 < nv;
  const int qpos0 = ok0 ? vr0 % nq + nk - nq : 0;
  const int qpos1 = ok1 ? vr1 % nq + nk - nq : 0;
  const float lse0 = ok0 ? a.lse[stat_off(a, bb, g, vr0)] : 0.f;
  const float lse1 = ok1 ? a.lse[stat_off(a, bb, g, vr1)] : 0.f;
  const float dd0 = ok0 ? a.dsum[stat_off(a, bb, g, vr0)] : 0.f;
  const float dd1 = ok1 ? a.dsum[stat_off(a, bb, g, vr1)] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int buf = 0;
  for (int t = t_lo; t <= t_hi; ++t, buf ^= 1) {
    if (t < t_hi) {
      stage_keys_async<BC, DP, kDqThreads>(k_s + (buf ^ 1) * BC * S, kp, a, bb, g, (t + 1) * BC,
                                           tid);
      stage_keys_async<BC, DP, kDqThreads>(v_s + (buf ^ 1) * BC * S, vp, a, bb, g, (t + 1) * BC,
                                           tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + buf * BC * S;
    const bf16* vt = v_s + buf * BC * S;

    // ---- S = Q·Kᵀ, dP = dO·Vᵀ (16 rows x BC keys a warp), then p and dS
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<NT, DP>(s, q_s + warp * 16 * S, kt, lane);
    mma_abt<NT, DP>(dp, g_s + warp * 16 * S, vt, lane);
    const int key0 = t * BC;
    const bool full = key0 + BC <= nk && (!a.causal || key0 + BC - 1 <= first_q) &&
                      (!a.use_window || key0 > last_q - a.window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * tq + (e & 1);
        const bool mk =
            full || ((e < 2) ? (ok0 && visible(a, key, qpos0)) : (ok1 && visible(a, key, qpos1)));
        float fac;
        const float p =
            mk ? expf(capped<CAP>(s[n][e] * a.scale, a.softcap, &fac) - (e < 2 ? lse0 : lse1))
               : 0.f;
        if constexpr (CAP) {
          dp[n][e] = mk ? p * (dp[n][e] - (e < 2 ? dd0 : dd1)) * fac : 0.f;
        } else {
          dp[n][e] = p * (dp[n][e] - (e < 2 ? dd0 : dd1));
        }
      }
    uint32_t df[2][NT / 2][4];
    split_frags<NT>(df, dp);

    // ---- dQ += dS·K (K read through ldmatrix.trans)
    mma_frag_b<NT / 2, NO, DP>(acc, df, kt, 0, lane);
    __syncthreads();  // this buffer is consumed before the next prefetch overwrites it
  }
  cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int vr = half ? vr1 : vr0;
    if (vr >= nv) continue;
    const long long off = row_off(a, bb, g, vr);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col >= a.d) continue;
      *reinterpret_cast<uint32_t*>(dq + off + col) =
          pack2(__float2bfloat16_rn(acc[n][2 * half] * a.scale),
                __float2bfloat16_rn(acc[n][2 * half + 1] * a.scale));
    }
  }
}

// ------------------------------------------------------------ launch

template <typename T, int DP, bool CAP>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv<T, DP, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq<T, DP, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_rows = static_cast<long long>(a.b) * a.nq * a.h;
  bwd_dsum<T><<<static_cast<unsigned>((n_rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
                0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  const dim3 grid_kv(static_cast<unsigned>((a.nk + kBC - 1) / kBC),
                     static_cast<unsigned>(a.b * a.kvh));
  bwd_dkdv<T, DP, CAP><<<grid_kv, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>((nv + kBR - 1) / kBR), static_cast<unsigned>(a.b * a.kvh));
  bwd_dq<T, DP, CAP><<<grid_q, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool CAP>
cudaError_t launch_simt_width(const Args& a, int width, const int tiles[3], cudaStream_t stream) {
  if (a.d > width || a.splits != 1 || tiles[0] != kBC || tiles[1] != kBR || tiles[2] != kBR)
    return cudaErrorInvalidValue;
  switch (width) {
    case 32: return launch_simt<T, 32, CAP>(a, stream);
    case 64: return launch_simt<T, 64, CAP>(a, stream);
    case 128: return launch_simt<T, 128, CAP>(a, stream);
    case 192: return launch_simt<T, 192, CAP>(a, stream);
    case 256: return launch_simt<T, 256, CAP>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DP, bool CAP>
cudaError_t launch_mma(const Args& a, const int tiles[3], cudaStream_t stream) {
  if (tiles[0] != kKvKeys || tiles[1] != 16 * dq_warps<DP>() || tiles[2] != kKvRows)
    return cudaErrorInvalidValue;
  constexpr size_t kv_smem = kv_smem_bytes<DP>();
  constexpr size_t dq_smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv_mma<DP, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_mma<DP, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return err;
  const long long n_rows = static_cast<long long>(a.b) * a.nq * a.h;
  bwd_dsum<bf16><<<static_cast<unsigned>((n_rows + kThreads / 32 - 1) / (kThreads / 32)),
                   kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long groups = static_cast<long long>(a.b) * a.kvh;
  const long long n_kv = (a.nk + kKvKeys - 1) / kKvKeys * a.splits * groups;
  bwd_dkdv_mma<DP, CAP><<<static_cast<unsigned>(n_kv), 128 * kv_group_warps<DP>(), kv_smem,
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.splits > 1) {
    const long long n_el = static_cast<long long>(a.b) * a.nk * a.kvh * a.d;
    bwd_dkdv_reduce<<<static_cast<unsigned>((n_el + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  constexpr int dq_rows = 16 * dq_warps<DP>();
  bwd_dq_mma<DP, CAP><<<static_cast<unsigned>((nv + dq_rows - 1) / dq_rows * groups),
                   32 * dq_warps<DP>(), dq_smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool CAP>
cudaError_t launch_mma_width(const Args& a, int width, const int tiles[3], cudaStream_t stream) {
  const long long groups = static_cast<long long>(a.b) * a.kvh;
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  if (a.d > width || a.d % 8 != 0 || (a.splits > 1 && a.part == nullptr) ||
      (a.nk + kKvKeys - 1) / kKvKeys * a.splits * groups > 0x7fffffffLL ||
      (nv + 63) / 64 * groups > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (width) {
    case 32: return launch_mma<32, CAP>(a, tiles, stream);
    case 64: return launch_mma<64, CAP>(a, tiles, stream);
    case 128: return launch_mma<128, CAP>(a, tiles, stream);
    case 192: return launch_mma<192, CAP>(a, tiles, stream);
    case 256: return launch_mma<256, CAP>(a, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches bwd_dsum and the route's
// kernels on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for what the kernel does not take). dtype 0 = fp32,
// 1 = bf16; route 0 = mma (bf16; d a multiple of 8; q, k, v, o, dout
// 16-byte aligned), 1 = simt (fp32; splits 1). Every tensor contiguous: q, o, dout,
// dq (b, nq, h, d); k, v, dk, dv (b, nk, kvh, d); lse and dsum (scratch for
// D) fp32 (b, h, nq); part, when splits > 1, fp32 (2, splits, b, nk, kvh, d).
// width in {32, 64, 128, 192, 256} >= d; b, nq, nk, h, kvh, d >= 1, h a
// multiple of kvh, b·kvh <= 65535, window >= 0 when used, softcap >= 0 (0: no
// cap; the capped instances otherwise). key_tile, row_tile
// and step_rows (the keys of a dk/dv block, the rows of a dq block, the rows of
// a dk/dv step) must be what the route is built for at this width: the
// caller's plan is refused otherwise, so a plan that is reported is the one
// that ran.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* dsum, void* dq,
                                    void* dk, void* dv, void* part, int dtype, int b, int nq,
                                    int nk, int h, int kvh, int d, int route, int width,
                                    int key_tile, int row_tile, int step_rows, int splits,
                                    int causal, int use_window, int window, float scale,
                                    float softcap, void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || h < 1 || kvh < 1 || d < 1 || h % kvh != 0 ||
      static_cast<long long>(b) * kvh > 65535 ||
      static_cast<long long>(h / kvh) * nq > 0x7fffffffLL || (use_window && window < 0) ||
      splits < 1 || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,  k,  v,  o,  dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
         dq, dk, dv, static_cast<float*>(part), b, nq, nk, h, kvh, d, causal, use_window,
         window, scale, softcap, splits};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const int tiles[3] = {key_tile, row_tile, step_rows};
  const bool cap = softcap > 0.f;
  if (route == 0 && dtype == 1)
    err = cap ? launch_mma_width<true>(a, width, tiles, st)
              : launch_mma_width<false>(a, width, tiles, st);
  if (route == 1 && dtype == 0)
    err = cap ? launch_simt_width<float, true>(a, width, tiles, st)
              : launch_simt_width<float, false>(a, width, tiles, st);
  return static_cast<int>(err);
}
