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
//   dv = Σ_i pᵀ dO,  dk = (Σ_i dSᵀ q)·scale           (bwd_dkdv)
//   dq = (Σ_j dS k)·scale                              (bwd_dq)
// written in the inputs' type. Each output element is summed by one thread
// in a fixed order, with no atomics: the gradient is deterministic, which
// makes a checkpoint restart bitwise on the card.
//
// Design: a simple one that is right (a tensor-core form is later work,
// ROADMAP Queue B). fp32 FMAs on CUDA cores. The work is 4 products of 2d
// operations per visible (query, key, head) in bwd_dkdv and 3 in bwd_dq, so it
// is bound by operations (67 TFLOP/s fp32 here; the bf16 tensor cores' 989
// would be its floor). Rows are the "virtual rows" of K-F: the (q head of the
// kv head's group, query) pairs, so one K/V tile serves the whole group.
// - bwd_dkdv: one block per (batch, kv head, tile of 32 keys). It keeps its
//   K and V tile in shared memory and dK, dV for its 32 keys in registers,
//   and walks every tile of 32 virtual rows that can see its keys (tiles no
//   row of which sees a key of the block are skipped): stage q, dO, lse, D;
//   S and dP (32 x 32, a 2 x 2 register tile a thread); p and dS to shared
//   memory; dV += pᵀ dO and dK += dSᵀ q (4 keys x d/32 columns a thread).
// - bwd_dq: one block per (batch, kv head, tile of 32 virtual rows), dQ in
//   registers, over every key tile its rows can see.
// Tiles are staged as fp32 with an odd row stride (no bank conflicts on the
// column reads); d is padded to the instantiated width DP (32, 64, 128, 192,
// 256) with zeros.

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
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

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
  int b, nq, nk, h, kvh, d;
  int causal, use_window, window;
  float scale;
};

constexpr int kThreads = 256;
constexpr int kBR = 32;       // virtual rows per tile
constexpr int kBC = 32;       // keys per tile
constexpr int kPS = kBC + 1;  // row stride of the p / dS tiles

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
template <int DP>
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
      const float p = mk ? expf(sa[r][c] * a.scale - lse_s[row]) : 0.f;
      p_s[row * kPS + col] = p;
      ds_s[row * kPS + col] = p * (pa[r][c] - dsum_s[row]);
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

template <typename T, int DP>
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
    tile_p_ds<DP>(a, q_s, g_s, k_s, v_s, lse_s, dsum_s, p_s, ds_s, v0, nv, k0, tid);
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

template <typename T, int DP>
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
    tile_p_ds<DP>(a, q_s, g_s, k_s, v_s, lse_s, dsum_s, p_s, ds_s, v0, nv, k0, tid);
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

// ------------------------------------------------------------ launch

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  bwd_dkdv<T, DP><<<grid_kv, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>((nv + kBR - 1) / kBR), static_cast<unsigned>(a.b * a.kvh));
  bwd_dq<T, DP><<<grid_q, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const Args& a, int width, cudaStream_t stream) {
  if (a.d > width) return cudaErrorInvalidValue;
  switch (width) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 192: return launch<T, 192>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches bwd_dsum, bwd_dkdv and
// bwd_dq on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for what the kernel does not take). dtype 0 = fp32,
// 1 = bf16. Every tensor contiguous: q, o, dout, dq (b, nq, h, d); k, v, dk,
// dv (b, nk, kvh, d); lse and dsum (scratch for D) fp32 (b, h, nq). width in
// {32, 64, 128, 192, 256} >= d; b, nq, nk, h, kvh, d >= 1, h a multiple of
// kvh, b·kvh <= 65535, window >= 0 when used.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* dsum, void* dq,
                                    void* dk, void* dv, int dtype, int b, int nq, int nk, int h,
                                    int kvh, int d, int width, int causal, int use_window,
                                    int window, float scale, void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || h < 1 || kvh < 1 || d < 1 || h % kvh != 0 ||
      static_cast<long long>(b) * kvh > 65535 ||
      static_cast<long long>(h / kvh) * nq > 0x7fffffffLL || (use_window && window < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,  k,  v,  o,  dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
         dq, dk, dv, b,  nq,   nk, h, kvh, d, causal, use_window, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_width<float>(a, width, st);
  if (dtype == 1) err = launch_width<bf16>(a, width, st);
  return static_cast<int>(err);
}
