// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel _fa_kernel
// (src/repro/kernels/flash_attention.py:27), wrapper flash_attention_pallas
// (:88, pallas_call at :118).
//
// What it computes. q (b, nq, h, d), k and v (b, nk, kvh, d), bf16 or fp32,
// with any batch, sequence and head strides (the last axis contiguous), so
// a live slice k[:, :n] of a decode cache is read in place. Query head hq
// reads kv head hq / (h / kvh) (GQA). Query row i sits at position
// i + nk - nq (right-aligned: prefill when nq = nk, decode when nq = 1). Key
// j is visible to it when j < nk, j <= its position (causal) and
// j > its position - window (a window). Over keys in tiles of 128, in
// order, with inputs upcast to fp32:
//   s = (q · k) * scale, masked to -1e30
//   m' = max(m, max s)   p = exp(s - m') (0 where masked)
//   l = l * exp(m - m') + Σ p      acc = acc * exp(m - m') + p · v
// and o = acc / max(l, 1e-30), cast to q's type: a row that sees no key is 0.
// s, p and p · v are fp32 end to end (p is never rounded to bf16), exp is
// expf and the division IEEE (never build with --use_fast_math). A key tile
// that no row of the block can see is skipped before its load; for a row
// that sees none of a tile the update above is exactly a no-op, so skipping
// changes no bit.
//
// Layout. A block serves BQ query rows of one kv head: the rows are the
// (q head of the kv head's group, query) pairs, so in decode (nq = 1) one
// block serves the group's h / kvh heads and reads the kv head once. 256
// threads. The block holds its queries in shared memory (fp32), stages each
// 128-key tile's K and then V 64 keys at a time, computes the tile's logits
// as a register tile per thread (BQ / 16 rows x 4 keys), takes the online
// softmax update with 256 / BQ threads per row (shuffle max and sum), and
// accumulates p · v into a register tile (BQ / 16 rows x d / 16 columns).
// BQ is 64, or 16 when the block's rows are few (decode).
//
// What bounds it on this card. Prefill (nq = nk = 2,048, d = 128): ~4·nq·nk/2·d
// fp32 operations per (batch, head) against 2·(nq + 2·nk)·d bytes of bf16,
// hundreds of operations a byte: bound by the fp32 pipe (67 TFLOP/s at 700 W;
// this kernel reads two shared-memory operands per two FMAs, so it reaches
// at most about half of that). Decode (nq = 1): bound by reading the kv
// cache, 2·nk·kvh·d·2 bytes per batch row, at 3.35 TB/s.
//
// This is the simple, correct first version: fp32 FMAs on CUDA cores, no
// tensor cores (a bf16 mma for p · v would round p and compute a different
// function; wgmma must keep p in fp32 or split it hi/lo), no TMA, no
// split-KV decode. Making it fast is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 128;   // keys per softmax tile (the TPU kernel's bk)
constexpr int kHalf = 64;  // keys staged at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qsn, qsh;  // element strides of q, k, v (the last axis is contiguous)
  long long ksb, ksn, ksh;
  long long vsb, vsn, vsh;
  int nq, nk, h, kvh;
  int causal, use_window, window;
  float scale;
};

// Stage kHalf rows of K or V (rows row0.., fp32, stride DP) into
// shared memory; rows at or past n are zeros. The trip count is a
// compile-time constant, so the loads of 8 iterations are in flight
// together instead of one at a time.
template <typename T, int D>
__device__ __forceinline__ void stage_half(float* dst, const T* src, long long base,
                                           long long row_stride, int row0, int n, int tid) {
  constexpr int DP = D + 1;
  constexpr int kPer = kHalf * D / kThreads;
#pragma unroll 8
  for (int it = 0; it < kPer; ++it) {
    const int e = it * kThreads + tid;
    const int r = e / D;
    const int j = e - r * D;
    const int key = row0 + r;
    dst[r * DP + j] = key < n ? to_f(src[base + key * row_stride + j]) : 0.f;
  }
}

template <int D, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) + kHalf * (D + 1) +
                          static_cast<size_t>(BQ) * (kBK + 1) + 3 * BQ);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) fa_forward(const Args a) {
  constexpr int DP = D + 1;        // odd row stride: lanes reading 16 rows hit distinct banks
  constexpr int SP = kBK + 1;
  constexpr int RPT = BQ / 16;     // rows per thread in the register tiles
  constexpr int CPT = D / 16;      // output columns per thread
  constexpr int TPR = kThreads / BQ;  // threads per row in the softmax update
  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x DP
  float* kv_s = q_s + BQ * DP;     // kHalf x DP: K, then V, of half a tile
  float* s_s = kv_s + kHalf * DP;  // BQ x SP: logits, then p
  float* m_s = s_s + BQ * SP;      // BQ running max
  float* l_s = m_s + BQ;           // BQ running sum
  float* al_s = l_s + BQ;          // BQ rescale factor of the current tile

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int nq = a.nq, nk = a.nk;
  const int rep = a.h / a.kvh;
  const int g = blockIdx.y % a.kvh;
  const long long b = blockIdx.y / a.kvh;
  const int nv = rep * nq;              // virtual rows of this kv head
  const int v0 = blockIdx.x * BQ;
  const int v1 = min(v0 + BQ, nv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  // the block's range of query positions (its rows may span two heads)
  int lo_i, hi_i;
  if (v0 / nq == (v1 - 1) / nq) {
    lo_i = v0 % nq;
    hi_i = (v1 - 1) % nq;
  } else {
    lo_i = 0;
    hi_i = nq - 1;
  }
  const int first_q = lo_i + nk - nq;
  const int last_q = hi_i + nk - nq;

#pragma unroll 4
  for (int it = 0; it < BQ * D / kThreads; ++it) {
    const int e = it * kThreads + tid;
    const int r = e / D;
    const int j = e - r * D;
    const int vr = v0 + r;
    float val = 0.f;
    if (vr < nv) {
      const int hh = vr / nq;
      const int i = vr - hh * nq;
      val = to_f(q[b * a.qsb + i * a.qsn + static_cast<long long>(g * rep + hh) * a.qsh + j]);
    }
    q_s[r * DP + j] = val;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  // this thread's softmax row
  const int srow = tid / TPR;
  const int ssub = tid - srow * TPR;
  const int sv = v0 + srow;
  const bool srow_ok = sv < nv;
  const int sqpos = srow_ok ? (sv % nq) + nk - nq : 0;

  const int n_tiles = (nk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int first_k = kt * kBK;
    const int last_k = first_k + kBK - 1;
    bool relevant = v0 < nv;
    if (a.causal) relevant = relevant && first_k <= last_q;
    if (a.use_window) relevant = relevant && last_k > first_q - a.window;
    if (!relevant) continue;  // block-uniform

    // ---- logits s = (q · k) * scale, masked, for the tile's two halves
    for (int half = 0; half < 2; ++half) {
      const int kb = first_k + half * kHalf;
      __syncthreads();  // kv_s is free
      stage_half<T, D>(kv_s, k, b * a.ksb + g * a.ksh, a.ksn, kb, nk, tid);
      __syncthreads();
      float sacc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sacc[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < D; ++j) {
        float qa[RPT], kb4[4];
#pragma unroll
        for (int r = 0; r < RPT; ++r) qa[r] = q_s[(ty + 16 * r) * DP + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) kb4[c] = kv_s[(tx + 16 * c) * DP + j];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sacc[r][c] = fmaf(qa[r], kb4[c], sacc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty + 16 * r;
        const int vr = v0 + row;
        const int qpos = vr < nv ? (vr % nq) + nk - nq : 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = half * kHalf + tx + 16 * c;
          const int key = first_k + col;
          bool mk = vr < nv && key < nk;
          if (a.causal) mk = mk && key <= qpos;
          if (a.use_window) mk = mk && key > qpos - a.window;
          s_s[row * SP + col] = mk ? sacc[r][c] * a.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // ---- online softmax update, TPR threads per row
    {
      float mx = kNegInf;
      for (int c = ssub; c < kBK; c += TPR) mx = fmaxf(mx, s_s[srow * SP + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[srow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = ssub; c < kBK; c += TPR) {
        const int key = first_k + c;
        bool mk = srow_ok && key < nk;
        if (a.causal) mk = mk && key <= sqpos;
        if (a.use_window) mk = mk && key > sqpos - a.window;
        const float p = mk ? expf(s_s[srow * SP + c] - m_new) : 0.f;
        s_s[srow * SP + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (ssub == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[srow] = l_s[srow] * alpha + sum;
        m_s[srow] = m_new;
        al_s[srow] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float alpha = al_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= alpha;
    }

    // ---- acc += p · v, the tile's two halves
    for (int half = 0; half < 2; ++half) {
      const int kb = first_k + half * kHalf;
      __syncthreads();  // kv_s is free
      stage_half<T, D>(kv_s, v, b * a.vsb + g * a.vsh, a.vsn, kb, nk, tid);
      __syncthreads();
#pragma unroll 4
      for (int c2 = 0; c2 < kHalf; ++c2) {
        float pr[RPT], vv[CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) pr[r] = s_s[(ty + 16 * r) * SP + half * kHalf + c2];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = kv_s[c2 * DP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
      }
    }
  }
  __syncthreads();

  // ---- o = acc / max(l, 1e-30), written as (b, nq, h, d)
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = ty + 16 * r;
    const int vr = v0 + row;
    if (vr >= nv) continue;
    const int hh = vr / nq;
    const int i = vr - hh * nq;
    const float den = fmaxf(l_s[row], 1e-30f);
    T* orow = o + ((b * nq + i) * a.h + g * rep + hh) * static_cast<long long>(D);
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = from_f<T>(acc[r][c] / den);
  }
}

template <typename T, int D, int BQ>
cudaError_t launch_bq(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(fa_forward<T, D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  const dim3 grid(static_cast<unsigned>((nv + BQ - 1) / BQ),
                  static_cast<unsigned>(batch * a.kvh));
  fa_forward<T, D, BQ><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const Args& a, int batch, cudaStream_t stream) {
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  return nv <= 16 ? launch_bq<T, D, 16>(a, batch, stream) : launch_bq<T, D, 64>(a, batch, stream);
}

template <typename T>
cudaError_t launch_t(const Args& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<T, 16>(a, batch, stream);
    case 32: return launch_d<T, 32>(a, batch, stream);
    case 64: return launch_d<T, 64>(a, batch, stream);
    case 128: return launch_d<T, 128>(a, batch, stream);
    case 256: return launch_d<T, 256>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for what the
// kernel does not take: dtype 0 = fp32 or 1 = bf16; d in {16, 32, 64, 128,
// 256}; b, nq, h, kvh >= 1, nk >= 0, h a multiple of kvh, b·kvh <= 65535;
// window >= 0 when used). The output is (b, nq, h, d), contiguous.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v, void* o, int dtype,
                                int b, int nq, int nk, int h, int kvh, int d, long long qsb,
                                long long qsn, long long qsh, long long ksb, long long ksn,
                                long long ksh, long long vsb, long long vsn, long long vsh,
                                int causal, int use_window, int window, float scale,
                                void* stream) {
  if (b < 1 || nq < 1 || nk < 0 || h < 1 || kvh < 1 || h % kvh != 0 ||
      static_cast<long long>(b) * kvh > 65535 ||
      static_cast<long long>(h / kvh) * nq > 0x7fffffffLL || (use_window && window < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
         nq, nk, h, kvh, causal, use_window, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_t<float>(a, b, d, st));
  if (dtype == 1) return static_cast<int>(launch_t<__nv_bfloat16>(a, b, d, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
