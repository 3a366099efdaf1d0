// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel _fa_kernel
// (src/repro/kernels/flash_attention.py:27), wrapper flash_attention_pallas
// (:88, pallas_call at :118).
//
// What it computes. q (b, nq, h, d), k and v (b, nk, kvh, d), bf16 or fp32,
// any d, with any batch, sequence and head strides (the last axis
// contiguous), so a live slice k[:, :n] of a decode cache is read in place.
// Query head hq reads kv head hq / (h / kvh) (GQA). Query row i sits at
// position i + nk - nq (right-aligned: prefill when nq = nk, decode when
// nq = 1). Key j is visible to it when j < nk, j <= its position (causal)
// and j > its position - window (a window). Over key tiles, in order, with
// inputs upcast to fp32:
//   s = (q · k) * scale, capped s = cap · tanh(s / cap) when cap > 0, masked to -1e30
//   m' = max(m, max s)   p = exp(s - m') (0 where masked)
//   l = l * exp(m - m') + Σ p      acc = acc * exp(m - m') + p · v
// and o = acc / max(l, 1e-30), cast to q's type: a row that sees no key is 0.
// Given an lse pointer (training: FlashAttentionFn in
// kernels/flash_attention.py), each form also writes the row's log-sum-exp
// lse = m + log l (fp32, (b, h, nq); -inf for a row that sees no key), which
// the backward kernel (flash_attn_bwd.cu) recomputes p from. Every
// instruction that produces o is the same with and without it.
// The logit softcap (Gemma 2's attn_logit_softcapping; the JAX package's
// _sdpa) is a compile-time variant of every kernel: cap = 0 runs the
// instances without it, so the uncapped kernels keep their instructions. The
// cap is applied to the scaled logit before the mask is written (a masked key
// stays at -1e30, never -cap), with IEEE tanhf (no tanh.approx.f32).
// A second key/value source (the read-only serving cache's decode: the
// cache's live keys read in place through their strides, then the step's
// fresh keys) is logically appended after the first source's nk1 keys: key j
// of the nk = nk1 + nk2 keys is read from k2 / v2 at j - nk1 when j >= nk1.
// Only fa_simt takes it (the wrapper plans that route); nothing is copied.
// p is never rounded below fp32, exp is expf and the division IEEE (never
// build with --use_fast_math). A key tile that no row of the block can see
// is skipped before its load; for a row that sees none of a tile the update
// above is exactly a no-op, so skipping changes no bit.
//
// Three kernels, chosen by the wrapper's plan (kernels/flash_attention.py,
// plan_attention), which is computed on the host from the shapes alone.
//
// fa_mma — bf16 with more than 16 rows per kv head (prefill), d <= 256.
//   Bound on this card by operations: the work is ~4·d flops per visible
//   (query, key) pair per head, hundreds of flops per byte, which fp32
//   FMAs on CUDA cores would cap at 67 TFLOP/s. So every product runs on
//   the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate):
//   - S = Q·Kᵀ is one bf16 MMA chain: a bf16 × bf16 product is exact in
//     fp32, so this is the upcast dot product up to the order of its sums.
//   - P·V keeps p exact: each fp32 p (scaled by 2^32, exact, so that every
//     term stays a normal bf16 down to p = 2^-149) is split into three bf16
//     terms hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), whose
//     sum is p to the bit (3 × 8 significand bits cover fp32's 24); hi·V,
//     mid·V and lo·V are three MMAs into one fp32 accumulator per key
//     tile (the tensor cores' fp32 additions are not IEEE round-to-nearest,
//     so no accumulator runs longer than a tile); each tile's sum is added
//     to the running output with an IEEE add, as the TPU kernel adds each
//     tile's p·v, and the output is scaled back by 2^-32 (exact) before the
//     division. A two-term split would round p and compute another
//     function. This design's floor is twice the bound: 2d flops of q·k
//     and 3 x 2d of p·v per pair.
//   A block serves 64 virtual rows (the (q head of the kv head's group,
//   query) pairs, so the group reads its K/V tile once), 4 warps of 16 rows.
//   K and V tiles of 64 keys are staged by cp.async (16-byte chunks,
//   zero-filled past nk and past d) into a double buffer: the next tile's
//   loads are in flight while the current one is computed. The online
//   softmax state (m, l per row) and the output tile stay in registers; the
//   P fragments go from the S accumulators to the A operand of P·V without
//   touching shared memory. d is padded to the instantiated width DK (64,
//   128, 256) with zeros (+0 products leave every fp32 sum unchanged); the
//   output's d is cut into chunks of 128 across grid.z, each block
//   recomputing the logits. Blocks walk their query tiles last-first so the
//   long causal rows start first. This uses mma.sync, not wgmma: wgmma's
//   shared-memory descriptors and swizzles could not be checked without a
//   compiler before the first chip call; mma.sync with ldmatrix reaches the
//   tensor cores on sm_90a at a lower share of their peak.
//
// fa_simt — fp32 (the reduced model's parity path), decode (<= 16 rows per
//   kv head) and bf16 with d > 256. fp32 FMAs on CUDA cores. Decode is
//   bound by reading the kv cache (2·nk·kvh·d·2 bytes per batch row at
//   3.35 TB/s), and one block per (batch row, kv head) would be 64 blocks
//   for 132 SMs at the LM decode shape, each walking all keys. So the key
//   range is split across grid.z (split-KV, ~4 blocks per SM, the split
//   count from the shapes alone) and K/V are loaded as 16-byte vectors.
//   Each split writes its partial (m, l, acc) in fp32 to scratch, and
//   fa_combine rescales the partials by exp(m_i - m) and divides once; a
//   split that sees none of a row's keys has m = -1e30, l = 0, acc = 0 and
//   drops out, and a row that sees no key at all still comes out 0. Any d:
//   the logits run over d in chunks of 128 staged in shared memory, the
//   output's d in chunks of DV (<= 128) across grid.z.
//
// fa_combine — the split-KV merge, one thread per output element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kPScale = 4294967296.0f;         // 2^32
constexpr float kPUnscale = 2.3283064365386963e-10f;  // 2^-32

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
  const void* k2;   // the second source (k2 = k, v2 = v, nk1 = nk when there is none)
  const void* v2;
  void* o;
  float* part_m;    // split-KV partials (null when splits == 1):
  float* part_l;    //   (splits, b·nq·h) and
  float* part_acc;  //   (splits, b·nq·h, d)
  float* lse;       // each row's m + log l, (b, h, nq), or null
  long long qsb, qsn, qsh;  // element strides of q, k, v (the last axis is contiguous)
  long long ksb, ksn, ksh;
  long long vsb, vsn, vsh;
  long long k2sb, k2sn, k2sh;
  long long v2sb, v2sn, v2sh;
  int b, nq, nk, h, kvh, d;
  int nk1;         // keys of the first source; keys nk1 .. nk - 1 come from k2 / v2
  int causal, use_window, window;
  float scale;
  float softcap;   // > 0: the capped instances run
  int zc;          // chunks of the output's d (grid.z = zc · splits)
  int splits;      // key ranges [s·split_keys, (s+1)·split_keys)
  int split_keys;
};

// The scaled logit s, capped to cap · tanh(s / cap) in the CAP instances
// (the JAX package's tanh(s / cap) * cap).
template <bool CAP>
__device__ __forceinline__ float capped(float s, float cap) {
  if constexpr (CAP) {
    return tanhf(s / cap) * cap;
  } else {
    return s;
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

// The block's range of query positions (its rows v0..v1-1 may span heads).
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

// ------------------------------------------------------------ fa_mma

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
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

// p (already scaled by 2^32) = hi + mid + lo exactly, each a bf16.
__device__ __forceinline__ void split3(float p, bf16* hi, bf16* mid, bf16* lo) {
  *hi = __float2bfloat16_rn(p);
  const float r1 = p - __bfloat162float(*hi);
  *mid = __float2bfloat16_rn(r1);
  *lo = __float2bfloat16_rn(r1 - __bfloat162float(*mid));
}

constexpr int kMmaThreads = 128;
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

template <int DK, int DV>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (static_cast<size_t>(kMmaBQ) * (DK + 8) +
                         2 * static_cast<size_t>(kMmaBK) * (DK + 8) +
                         2 * static_cast<size_t>(kMmaBK) * (DV + 8));
}

// Stage 64 rows x COLS bf16 (row r at src + (row0 + r)·rs, columns from
// col0) into dst (row stride STRIDE); rows at or past n_rows and columns at
// or past ncols read as 0.
template <int COLS, int STRIDE, bool VEC>
__device__ __forceinline__ void stage_kv(bf16* dst, const bf16* src, long long rs, int row0,
                                         int n_rows, int ncols, int tid) {
  if constexpr (VEC) {
    constexpr int CH = COLS / 8;
#pragma unroll 4
    for (int e = tid; e < kMmaBK * CH; e += kMmaThreads) {
      const int r = e / CH;
      const int c = (e - r * CH) * 8;
      const bool ok = row0 + r < n_rows && c < ncols;
      cp_async16(dst + r * STRIDE + c, ok ? src + (row0 + r) * rs + c : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kMmaBK * COLS; e += kMmaThreads) {
      const int r = e / COLS;
      const int c = e - r * COLS;
      dst[r * STRIDE + c] = (row0 + r < n_rows && c < ncols) ? src[(row0 + r) * rs + c]
                                                             : __ushort_as_bfloat16(0);
    }
  }
}

template <int DK, int DV, bool VEC, bool CAP>
__global__ void __launch_bounds__(kMmaThreads) fa_mma(const Args a) {
  constexpr int QS = DK + 8;  // row strides in bf16: rows 16 bytes apart mod 128 (no bank conflicts)
  constexpr int VS = DV + 8;
  constexpr int NT = kMmaBK / 8;   // n-tiles of S
  constexpr int NO = DV / 8;       // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BQ x QS
  bf16* k_s = q_s + kMmaBQ * QS;                    // 2 x BK x QS
  bf16* v_s = k_s + 2 * kMmaBK * QS;                // 2 x BK x VS

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* o = static_cast<bf16*>(a.o);
  const int nq = a.nq, nk = a.nk, d = a.d;
  const int rep = a.h / a.kvh;
  const int g = blockIdx.y % a.kvh;
  const long long bb = blockIdx.y / a.kvh;
  const int nv = rep * nq;
  const int v0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;  // long causal rows first
  const int v1 = min(v0 + kMmaBQ, nv);
  const int z = blockIdx.z;
  const int col0 = z * DV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  int first_q, last_q;
  row_positions(a, v0, v1, &first_q, &last_q);
  const int n_tiles = (nk + kMmaBK - 1) / kMmaBK;
  int t_lo = 0, t_hi = n_tiles - 1;
  while (t_lo <= t_hi &&
         !tile_relevant(a, t_lo * kMmaBK, t_lo * kMmaBK + kMmaBK - 1, first_q, last_q))
    ++t_lo;
  while (t_hi >= t_lo &&
         !tile_relevant(a, t_hi * kMmaBK, t_hi * kMmaBK + kMmaBK - 1, first_q, last_q))
    --t_hi;

  const bf16* kbase = k + bb * a.ksb + g * a.ksh;
  const bf16* vbase = v + bb * a.vsb + g * a.vsh + col0;

  // Q (the block's virtual rows) and the first K/V tile
  {
    constexpr int CH = DK / 8;
    if constexpr (VEC) {
#pragma unroll 4
      for (int e = tid; e < kMmaBQ * CH; e += kMmaThreads) {
        const int r = e / CH;
        const int c = (e - r * CH) * 8;
        const int vr = v0 + r;
        const bool ok = vr < nv && c < d;
        const bf16* src = q;
        if (ok) {
          const int hh = vr / nq;
          src = q + bb * a.qsb + static_cast<long long>(vr - hh * nq) * a.qsn +
                static_cast<long long>(g * rep + hh) * a.qsh + c;
        }
        cp_async16(q_s + r * QS + c, src, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kMmaBQ * DK; e += kMmaThreads) {
        const int r = e / DK;
        const int c = e - r * DK;
        const int vr = v0 + r;
        bf16 val = __ushort_as_bfloat16(0);
        if (vr < nv && c < d) {
          const int hh = vr / nq;
          val = q[bb * a.qsb + static_cast<long long>(vr - hh * nq) * a.qsn +
                  static_cast<long long>(g * rep + hh) * a.qsh + c];
        }
        q_s[r * QS + c] = val;
      }
    }
  }
  if (t_lo <= t_hi) {
    stage_kv<DK, QS, VEC>(k_s, kbase, a.ksn, t_lo * kMmaBK, nk, d, tid);
    stage_kv<DV, VS, VEC>(v_s, vbase, a.vsn, t_lo * kMmaBK, nk, d - col0, tid);
  }
  cp_async_commit();

  // this thread's two rows (gq and gq + 8 of the warp's 16)
  const int vr0 = v0 + warp * 16 + gq;
  const int vr1 = vr0 + 8;
  const bool ok0 = vr0 < nv, ok1 = vr1 < nv;
  const int qpos0 = ok0 ? (vr0 % nq) + nk - nq : 0;
  const int qpos1 = ok1 ? (vr1 % nq) + nk - nq : 0;

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int buf = 0;
  for (int t = t_lo; t <= t_hi; ++t, buf ^= 1) {
    if (t < t_hi) {
      stage_kv<DK, QS, VEC>(k_s + (buf ^ 1) * kMmaBK * QS, kbase, a.ksn, (t + 1) * kMmaBK, nk,
                            d, tid);
      stage_kv<DV, VS, VEC>(v_s + (buf ^ 1) * kMmaBK * VS, vbase, a.vsn, (t + 1) * kMmaBK, nk,
                            d - col0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + buf * kMmaBK * QS;
    const bf16* vt = v_s + buf * kMmaBK * VS;

    // ---- S = Q·Kᵀ (16 rows x 64 keys a warp)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const bf16* qa = q_s + (warp * 16 + gq) * QS + kk * 16 + 2 * tq;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * QS);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * QS + 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // B fragments of key tiles n and n + 1: matrices (keys, d) of 8 x 8
        uint32_t bk[4];
        const int mi = lane >> 3;
        ldmatrix_x4(bk, kt + ((n + (mi >> 1)) * 8 + (lane & 7)) * QS + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[n], a0, a1, a2, a3, bk[0], bk[1]);
        mma_bf16(s[n + 1], a0, a1, a2, a3, bk[2], bk[3]);
      }
    }

    // ---- scale, mask, online softmax (rows gq and gq + 8; 4 lanes a row)
    const int key0 = t * kMmaBK;
    // a tile every row of the block sees whole needs no mask
    const bool full = key0 + kMmaBK <= nk && (!a.causal || key0 + kMmaBK - 1 <= first_q) &&
                      (!a.use_window || key0 > last_q - a.window);
    uint32_t vis = 0xffffffffu;
    float mx0 = kNegInf, mx1 = kNegInf;
    if (full) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = capped<CAP>(s[n][0] * a.scale, a.softcap);
        s[n][1] = capped<CAP>(s[n][1] * a.scale, a.softcap);
        s[n][2] = capped<CAP>(s[n][2] * a.scale, a.softcap);
        s[n][3] = capped<CAP>(s[n][3] * a.scale, a.softcap);
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    } else {
      vis = 0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * tq + (e & 1);
          const bool mk =
              (e < 2) ? (ok0 && visible(a, key, qpos0)) : (ok1 && visible(a, key, qpos1));
          s[n][e] = mk ? capped<CAP>(s[n][e] * a.scale, a.softcap) : kNegInf;
          if (mk) vis |= 1u << (n * 4 + e);
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]); else mx1 = fmaxf(mx1, s[n][e]);
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool mk = (vis >> (n * 4 + e)) & 1u;
        const float p = mk ? expf(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[n][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    l0 = l0 * al0 + sum0;  // this lane's share of the row sum (summed over 4 lanes at the end)
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // ---- acc += p·V, p = hi + mid + lo exactly (three bf16 MMAs). The
    // tile's p·V is summed in its own fp32 accumulator (a chain of 12 MMA
    // k-steps, smallest terms first) and added to acc once, as the TPU
    // kernel adds each tile's p·v: the tensor cores' accumulation then never
    // runs over more than one tile.
    uint32_t pf[3][kMmaBK / 16][4];  // (hi, mid, lo) A fragments of each 16-key step
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      bf16 h[8], m[8], lo[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split3(s[2 * kk][e] * kPScale, &h[e], &m[e], &lo[e]);
        split3(s[2 * kk + 1][e] * kPScale, &h[4 + e], &m[4 + e], &lo[4 + e]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[0][kk][r] = pack2(h[2 * r], h[2 * r + 1]);
        pf[1][kk][r] = pack2(m[2 * r], m[2 * r + 1]);
        pf[2][kk][r] = pack2(lo[2 * r], lo[2 * r + 1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) {
        uint32_t bv[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * VS + n * 8 +
                                  (mi >> 1) * 8);
#pragma unroll
        for (int term = 2; term >= 0; --term) {
          const uint32_t(&f)[4] = pf[term][kk];
          mma_bf16(t0, f[0], f[1], f[2], f[3], bv[0], bv[1]);
          mma_bf16(t1, f[0], f[1], f[2], f[3], bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] += t0[e];
        acc[n + 1][e] += t1[e];
      }
    }
    __syncthreads();  // this buffer is consumed before the next prefetch overwrites it
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no tile loaded only Q)

  // ---- o = acc / max(l, 1e-30), written as (b, nq, h, d)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (a.lse != nullptr && z == 0 && tq == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int vr = half ? vr1 : vr0;
      if (vr >= nv) continue;
      const int hh = vr / nq;
      const float l = half ? l1 : l0;
      a.lse[(bb * a.h + g * rep + hh) * nq + (vr - hh * nq)] =
          l > 0.f ? (half ? m1 : m0) + logf(l) : -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int vr = half ? vr1 : vr0;
    if (vr >= nv) continue;
    const int hh = vr / nq;
    const int i = vr - hh * nq;
    const float den = fmaxf(half ? l1 : l0, 1e-30f);
    bf16* orow = o + ((bb * nq + i) * a.h + g * rep + hh) * static_cast<long long>(d);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + n * 8 + 2 * tq + e;
        if (col < d) orow[col] = from_f<bf16>((acc[n][2 * half + e] * kPUnscale) / den);
      }
  }
}

// ------------------------------------------------------------ fa_simt

constexpr int kThreads = 256;
constexpr int kBK = 128;   // keys per softmax tile (the TPU kernel's bk)
constexpr int kHalf = 64;  // keys staged at once
constexpr int kDC = 128;   // width of one staged chunk of d
constexpr int kCP = kDC + 1;  // odd row stride: lanes reading 16 rows hit distinct banks

template <int BQ>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * kCP + kHalf * kCP +
                          static_cast<size_t>(BQ) * (kBK + 1) + 3 * BQ);
}

// Stage kHalf rows x kDC columns (row j at src + j·rs for j < n1, else at
// src2 + (j - n1)·rs2, for j = row0 + r; columns from the bases' offset) as
// fp32 into dst (row stride kCP); rows at or past n_rows and columns at or
// past ncols are 0. VEC: 16-byte loads (the wrapper checked the alignment of
// both sources).
template <typename T>
__device__ __forceinline__ const T* key_row(const T* src, long long rs, const T* src2,
                                            long long rs2, int n1, int j) {
  return j < n1 ? src + j * rs : src2 + (j - n1) * rs2;
}

template <typename T, bool VEC>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, long long rs, const T* src2,
                                          long long rs2, int n1, int row0, int n_rows, int ncols,
                                          int tid) {
  if constexpr (VEC) {
    constexpr int VW = 16 / sizeof(T);
    constexpr int CH = kDC / VW;
#pragma unroll 4
    for (int e = tid; e < kHalf * CH; e += kThreads) {
      const int r = e / CH;
      const int c = (e - r * CH) * VW;
      float* out = dst + r * kCP + c;
      if (row0 + r < n_rows && c < ncols) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(key_row(src, rs, src2, rs2, n1, row0 + r) + c);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VW; ++j) out[j] = to_f(vals[j]);
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) out[j] = 0.f;
      }
    }
  } else {
#pragma unroll 8
    for (int e = tid; e < kHalf * kDC; e += kThreads) {
      const int r = e / kDC;
      const int c = e - r * kDC;
      dst[r * kCP + c] = (row0 + r < n_rows && c < ncols)
                             ? to_f(key_row(src, rs, src2, rs2, n1, row0 + r)[c])
                             : 0.f;
    }
  }
}

template <typename T, int BQ>
__device__ __forceinline__ void stage_q(float* q_s, const Args& a, int v0, int c0, int tid) {
  const T* q = static_cast<const T*>(a.q);
  const int nq = a.nq, rep = a.h / a.kvh, nv = rep * nq;
  const int g = blockIdx.y % a.kvh;
  const long long bb = blockIdx.y / a.kvh;
  for (int e = tid; e < BQ * kDC; e += kThreads) {
    const int r = e / kDC;
    const int j = e - r * kDC;
    const int vr = v0 + r;
    float val = 0.f;
    if (vr < nv && c0 + j < a.d) {
      const int hh = vr / nq;
      const int i = vr - hh * nq;
      val = to_f(q[bb * a.qsb + i * a.qsn + static_cast<long long>(g * rep + hh) * a.qsh + c0 +
                   j]);
    }
    q_s[r * kCP + j] = val;
  }
}

template <typename T, int DV, int BQ, bool VEC, bool CAP>
__global__ void __launch_bounds__(kThreads) fa_simt(const Args a) {
  constexpr int SP = kBK + 1;
  constexpr int RPT = BQ / 16;        // rows per thread in the register tiles
  constexpr int CPT = DV / 16;        // output columns per thread
  constexpr int TPR = kThreads / BQ;  // threads per row in the softmax update
  extern __shared__ float smem[];
  float* q_s = smem;                // BQ x kCP: a chunk of the block's queries
  float* kv_s = q_s + BQ * kCP;     // kHalf x kCP: K (a chunk of d), then V, of half a tile
  float* s_s = kv_s + kHalf * kCP;  // BQ x SP: logits, then p
  float* m_s = s_s + BQ * SP;       // BQ running max
  float* l_s = m_s + BQ;            // BQ running sum
  float* al_s = l_s + BQ;           // BQ rescale factor of the current tile

  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* k2 = static_cast<const T*>(a.k2);
  const T* v2 = static_cast<const T*>(a.v2);
  T* o = static_cast<T*>(a.o);
  const int nq = a.nq, nk = a.nk, d = a.d;
  const int rep = a.h / a.kvh;
  const int g = blockIdx.y % a.kvh;
  const long long bb = blockIdx.y / a.kvh;
  const int nv = rep * nq;
  const int v0 = blockIdx.x * BQ;
  const int v1 = min(v0 + BQ, nv);
  const int z = blockIdx.z % a.zc;
  const int split = blockIdx.z / a.zc;
  const int col0 = z * DV;
  const int key_lo = split * a.split_keys;
  const int key_hi = min(nk, key_lo + a.split_keys);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n_chunks = (d + kDC - 1) / kDC;

  int first_q, last_q;
  row_positions(a, v0, v1, &first_q, &last_q);

  if (n_chunks == 1) stage_q<T, BQ>(q_s, a, v0, 0, tid);
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

  const T* kbase = k + bb * a.ksb + g * a.ksh;
  const T* vbase = v + bb * a.vsb + g * a.vsh + col0;
  const T* k2base = k2 + bb * a.k2sb + g * a.k2sh;
  const T* v2base = v2 + bb * a.v2sb + g * a.v2sh + col0;
  for (int first_k = key_lo; first_k < key_hi; first_k += kBK) {
    if (!(v0 < nv && tile_relevant(a, first_k, first_k + kBK - 1, first_q, last_q)))
      continue;  // block-uniform

    // ---- logits s = (q · k) * scale, masked, for the tile's two halves
    for (int half = 0; half < 2; ++half) {
      const int kb = first_k + half * kHalf;
      float sacc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sacc[r][c] = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int c0 = ch * kDC;
        __syncthreads();  // q_s / kv_s are free
        if (n_chunks > 1) stage_q<T, BQ>(q_s, a, v0, c0, tid);
        stage_f32<T, VEC>(kv_s, kbase + c0, a.ksn, k2base + c0, a.k2sn, a.nk1, kb, key_hi,
                          d - c0, tid);
        __syncthreads();
        const int w = min(kDC, d - c0);
#pragma unroll 4
        for (int j = 0; j < w; ++j) {
          float qa[RPT], kb4[4];
#pragma unroll
          for (int r = 0; r < RPT; ++r) qa[r] = q_s[(ty + 16 * r) * kCP + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) kb4[c] = kv_s[(tx + 16 * c) * kCP + j];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sacc[r][c] = fmaf(qa[r], kb4[c], sacc[r][c]);
        }
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
          const bool mk = vr < nv && key < key_hi && visible(a, key, qpos);
          s_s[row * SP + col] = mk ? capped<CAP>(sacc[r][c] * a.scale, a.softcap) : kNegInf;
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
        const bool mk = srow_ok && key < key_hi && visible(a, key, sqpos);
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

    // ---- acc += p · v (the block's DV output columns), the tile's two halves
    for (int half = 0; half < 2; ++half) {
      const int kb = first_k + half * kHalf;
      __syncthreads();  // kv_s is free
      stage_f32<T, VEC>(kv_s, vbase, a.vsn, v2base, a.v2sn, a.nk1, kb, key_hi, d - col0, tid);
      __syncthreads();
#pragma unroll 4
      for (int c2 = 0; c2 < kHalf; ++c2) {
        float pr[RPT], vv[CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) pr[r] = s_s[(ty + 16 * r) * SP + half * kHalf + c2];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = kv_s[c2 * kCP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
      }
    }
  }
  __syncthreads();

  // ---- one split: o = acc / max(l, 1e-30); several: the partial (m, l, acc)
  const long long n_rows = static_cast<long long>(a.b) * nq * a.h;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = ty + 16 * r;
    const int vr = v0 + row;
    if (vr >= nv) continue;
    const int hh = vr / nq;
    const int i = vr - hh * nq;
    const long long orow = (bb * nq + i) * a.h + g * rep + hh;
    if (a.splits == 1) {
      if (a.lse != nullptr && z == 0 && tx == 0)
        a.lse[(bb * a.h + g * rep + hh) * nq + i] =
            l_s[row] > 0.f ? m_s[row] + logf(l_s[row]) : -CUDART_INF_F;
      const float den = fmaxf(l_s[row], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = col0 + tx + 16 * c;
        if (col < d) o[orow * d + col] = from_f<T>(acc[r][c] / den);
      }
    } else {
      const long long prow = split * n_rows + orow;
      if (z == 0 && tx == 0) {
        a.part_m[prow] = m_s[row];
        a.part_l[prow] = l_s[row];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = col0 + tx + 16 * c;
        if (col < d) a.part_acc[prow * d + col] = acc[r][c];
      }
    }
  }
}

// ------------------------------------------------------------ fa_combine

// o = Σ_i acc_i·exp(m_i - m) / max(Σ_i l_i·exp(m_i - m), 1e-30), m = max_i m_i.
template <typename T>
__global__ void __launch_bounds__(kThreads) fa_combine(const Args a) {
  const long long n_rows = static_cast<long long>(a.b) * a.nq * a.h;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_rows * a.d) return;
  const long long row = e / a.d;
  float m = kNegInf;
  for (int s = 0; s < a.splits; ++s) m = fmaxf(m, a.part_m[s * n_rows + row]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float w = expf(a.part_m[s * n_rows + row] - m);
    l = fmaf(a.part_l[s * n_rows + row], w, l);
    acc = fmaf(a.part_acc[s * n_rows * a.d + e], w, acc);
  }
  static_cast<T*>(a.o)[e] = from_f<T>(acc / fmaxf(l, 1e-30f));
  if (a.lse != nullptr && e % a.d == 0) {  // row = (bb·nq + i)·h + hq
    const long long hq = row % a.h;
    const long long bi = row / a.h;        // bb·nq + i
    a.lse[((bi / a.nq) * a.h + hq) * a.nq + bi % a.nq] = l > 0.f ? m + logf(l) : -CUDART_INF_F;
  }
}

// ------------------------------------------------------------ launch

template <int DK, bool VEC, bool CAP>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int DV = DK < 128 ? DK : 128;
  constexpr size_t smem = mma_smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(fa_mma<DK, DV, VEC, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (a.zc != (a.d + DV - 1) / DV || a.splits != 1 || a.nk1 != a.nk) return cudaErrorInvalidValue;
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  const dim3 grid(static_cast<unsigned>((nv + kMmaBQ - 1) / kMmaBQ),
                  static_cast<unsigned>(a.b * a.kvh), static_cast<unsigned>(a.zc));
  fa_mma<DK, DV, VEC, CAP><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DV, int BQ, bool VEC, bool CAP>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<BQ>();
  cudaError_t err = cudaFuncSetAttribute(fa_simt<T, DV, BQ, VEC, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long nv = static_cast<long long>(a.h / a.kvh) * a.nq;
  const dim3 grid(static_cast<unsigned>((nv + BQ - 1) / BQ), static_cast<unsigned>(a.b * a.kvh),
                  static_cast<unsigned>(a.zc * a.splits));
  fa_simt<T, DV, BQ, VEC, CAP><<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n = static_cast<long long>(a.b) * a.nq * a.h * a.d;
  fa_combine<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DV, bool VEC, bool CAP>
cudaError_t launch_simt_bq(const Args& a, int bq, cudaStream_t stream) {
  if (bq == 16) return launch_simt<T, DV, 16, VEC, CAP>(a, stream);
  if (bq == 64) return launch_simt<T, DV, 64, VEC, CAP>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool VEC, bool CAP>
cudaError_t launch_simt_dv(const Args& a, int bq, int dv, cudaStream_t stream) {
  if (a.zc != (a.d + dv - 1) / dv || a.split_keys % kBK != 0 ||
      static_cast<long long>(a.splits) * a.split_keys < a.nk)
    return cudaErrorInvalidValue;
  if (a.splits > 1 && (a.part_m == nullptr || a.part_l == nullptr || a.part_acc == nullptr))
    return cudaErrorInvalidValue;
  switch (dv) {
    case 16: return launch_simt_bq<T, 16, VEC, CAP>(a, bq, stream);
    case 32: return launch_simt_bq<T, 32, VEC, CAP>(a, bq, stream);
    case 64: return launch_simt_bq<T, 64, VEC, CAP>(a, bq, stream);
    case 128: return launch_simt_bq<T, 128, VEC, CAP>(a, bq, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool VEC, bool CAP>
cudaError_t launch_route(const Args& a, int dtype, int route, int width, int bq,
                         cudaStream_t stream) {
  if (route == 0) {  // tensor cores: bf16, width = DK
    if (dtype != 1 || a.d > width) return cudaErrorInvalidValue;
    switch (width) {
      case 64: return launch_mma<64, VEC, CAP>(a, stream);
      case 128: return launch_mma<128, VEC, CAP>(a, stream);
      case 256: return launch_mma<256, VEC, CAP>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route == 1) {  // CUDA cores, split-KV: width = DV
    if (dtype == 0) return launch_simt_dv<float, VEC, CAP>(a, bq, width, stream);
    if (dtype == 1) return launch_simt_dv<bf16, VEC, CAP>(a, bq, width, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for what the
// kernel does not take). dtype 0 = fp32, 1 = bf16. The plan comes from the
// wrapper: route 0 = fa_mma (bf16, width = DK in {64, 128, 256} >= d, zc =
// ceil(d / min(DK, 128)), splits 1), route 1 = fa_simt (width = DV in {16,
// 32, 64, 128}, bq in {16, 64}, zc = ceil(d / DV), split_keys a multiple of
// 128 with splits·split_keys >= nk; splits > 1 needs the partials, fp32
// (splits, b·nq·h) for m and l and (splits, b·nq·h, d) for acc). lse: null,
// or fp32 (b, h, nq) for each row's log-sum-exp. k2 and v2 (null: none) are
// a second source of nk - nk1 keys, (b, nk - nk1, kvh, d) with their own
// strides, read after k and v's first nk1 keys (route 1 only). softcap >= 0
// (0: no cap). vec = 1: q, k, v (and k2, v2) are 16-byte aligned with
// strides and d multiples of 16 bytes' elements. b, nq, h, kvh, d >= 1,
// 0 <= nk1 <= nk, h a multiple of kvh, b·kvh <= 65535, zc·splits <= 65535,
// window >= 0 when used. The output is (b, nq, h, d), contiguous.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v, const void* k2,
                                const void* v2, void* o, void* part_m, void* part_l,
                                void* part_acc, void* lse, int dtype, int b, int nq, int nk,
                                int nk1, int h, int kvh, int d, long long qsb, long long qsn,
                                long long qsh, long long ksb, long long ksn, long long ksh,
                                long long vsb, long long vsn, long long vsh, long long k2sb,
                                long long k2sn, long long k2sh, long long v2sb, long long v2sn,
                                long long v2sh, int causal, int use_window, int window,
                                float scale, float softcap, int route, int width, int bq, int zc,
                                int splits, int split_keys, int vec, void* stream) {
  if (b < 1 || nq < 1 || nk < 0 || nk1 < 0 || nk1 > nk || h < 1 || kvh < 1 || d < 1 ||
      h % kvh != 0 || static_cast<long long>(b) * kvh > 65535 ||
      static_cast<long long>(h / kvh) * nq > 0x7fffffffLL || (use_window && window < 0) ||
      zc < 1 || splits < 1 || split_keys < 1 || static_cast<long long>(zc) * splits > 65535 ||
      !(softcap >= 0.f) || ((k2 == nullptr) != (v2 == nullptr)) ||
      (k2 == nullptr && nk1 != nk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k2 == nullptr) {  // one source: the second is never read
    k2 = k;
    v2 = v;
    k2sb = ksb, k2sn = ksn, k2sh = ksh;
    v2sb = vsb, v2sn = vsn, v2sh = vsh;
  }
  Args a{q,    k,    v,    k2,   v2,   o,    static_cast<float*>(part_m),
         static_cast<float*>(part_l),  static_cast<float*>(part_acc), static_cast<float*>(lse),
         qsb,  qsn,  qsh,  ksb,  ksn,  ksh,  vsb,  vsn,  vsh,  k2sb, k2sn, k2sh,
         v2sb, v2sn, v2sh, b,    nq,   nk,   h,    kvh,  d,    nk1,  causal, use_window,
         window, scale, softcap, zc, splits, split_keys};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (softcap > 0.f)
    err = vec ? launch_route<true, true>(a, dtype, route, width, bq, st)
              : launch_route<false, true>(a, dtype, route, width, bq, st);
  else
    err = vec ? launch_route<true, false>(a, dtype, route, width, bq, st)
              : launch_route<false, false>(a, dtype, route, width, bq, st);
  return static_cast<int>(err);
}
