// A warp's ascending run of any width k: the counterpart of the register
// runs of sorted_run.cuh for runs too wide for registers (K-G and K-D past
// k = 64, K-Q past mp = 512 or d = 128).
//
// The run lives in two ping-pong buffers of k (key, position) entries each,
// in device memory (the wrapper allocates them: a run of 100,000 entries
// fits nowhere else). Candidates that beat the run's tail gather in a
// per-warp shared-memory buffer of CAP entries; when it is full, and at the
// end, the warp sorts it (bitonic, in shared memory) and merges it into the
// run: every entry's rank in the merged run is its index plus the number of
// entries of the other list before it (a binary search), and entries whose
// rank is k or more drop out. Once the run has filled, most candidates fail
// the tail test with one compare, so merges are rare.
//
// Order: smaller key first; ties go to the lower position (run_before), so
// the run holds exactly the k smallest (key, position) pairs offered,
// whatever the order they came in. Every member is called by all 32 lanes
// of the warp with warp-uniform state.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sorted_run.cuh"

namespace repro_torch {

template <int CAP>
struct WideRun {
  static_assert(CAP >= 32 && (CAP & (CAP - 1)) == 0, "CAP: a power of two >= 32");
  float* rd[2];  // the run's two buffers (k entries each)
  int* rp[2];
  float* bd;     // candidate buffer (CAP entries, shared memory)
  int* bp;
  int k;
  int cur;       // the buffer holding the run
  int nb;        // candidates in the buffer
  float tail_d;  // the run's entry k - 1
  int tail_p;

  __device__ __forceinline__ void init(float* d0, int* p0, float* d1, int* p1, float* buf_d,
                                       int* buf_p, int width) {
    rd[0] = d0;
    rp[0] = p0;
    rd[1] = d1;
    rp[1] = p1;
    bd = buf_d;
    bp = buf_p;
    k = width;
    cur = 0;
    nb = 0;
    tail_d = CUDART_INF_F;
    tail_p = -1;
    for (int i = threadIdx.x & 31; i < k; i += 32) {
      d0[i] = CUDART_INF_F;
      p0[i] = -1;
    }
    __syncwarp();
  }

  // Offer one candidate per lane (`valid` false: none).
  __device__ __forceinline__ void offer(float d, int p, bool valid) {
    const int lane = threadIdx.x & 31;
    bool hit = valid && run_before(d, p, tail_d, tail_p);
    unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m == 0) return;
    if (nb + __popc(m) > CAP) {
      flush();
      hit = valid && run_before(d, p, tail_d, tail_p);
      m = __ballot_sync(0xffffffffu, hit);
      if (m == 0) return;
    }
    if (hit) {
      const int at = nb + __popc(m & ((1u << lane) - 1u));
      bd[at] = d;
      bp[at] = p;
    }
    nb += __popc(m);
    __syncwarp();
  }

  // Sort the buffer and merge it into the run.
  __device__ void flush() {
    if (nb == 0) return;
    const int lane = threadIdx.x & 31;
    int n2 = 32;
    while (n2 < nb) n2 <<= 1;
    for (int i = nb + lane; i < n2; i += 32) {
      bd[i] = CUDART_INF_F;
      bp[i] = -1;
    }
    __syncwarp();
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = lane; i < (n2 >> 1); i += 32) {
          const int lo = 2 * stride * (i / stride) + (i % stride);
          const int hi = lo + stride;
          const float dl = bd[lo], dh = bd[hi];
          const int pl = bp[lo], ph = bp[hi];
          const bool swap = (lo & size) == 0 ? run_before(dh, ph, dl, pl)
                                             : run_before(dl, pl, dh, ph);
          if (swap) {
            bd[lo] = dh;
            bp[lo] = ph;
            bd[hi] = dl;
            bp[hi] = pl;
          }
        }
        __syncwarp();
      }
    }
    const float* ad = rd[cur];
    const int* ap = rp[cur];
    float* od = rd[cur ^ 1];
    int* op = rp[cur ^ 1];
    for (int i = lane; i < k; i += 32) {  // the run's entries
      const float a = ad[i];
      const int pa = ap[i];
      int lo = 0, hi = nb;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run_before(bd[mid], bp[mid], a, pa)) lo = mid + 1; else hi = mid;
      }
      if (i + lo < k) {
        od[i + lo] = a;
        op[i + lo] = pa;
      }
    }
    for (int j = lane; j < nb; j += 32) {  // the buffer's entries
      const float b = bd[j];
      const int pb = bp[j];
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run_before(ad[mid], ap[mid], b, pb)) lo = mid + 1; else hi = mid;
      }
      if (j + lo < k) {
        od[j + lo] = b;
        op[j + lo] = pb;
      }
    }
    __syncwarp();
    cur ^= 1;
    nb = 0;
    tail_d = rd[cur][k - 1];
    tail_p = rp[cur][k - 1];
    __syncwarp();
  }

  __device__ __forceinline__ const float* keys() const { return rd[cur]; }
  __device__ __forceinline__ const int* positions() const { return rp[cur]; }
};

}  // namespace repro_torch
