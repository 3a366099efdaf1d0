// Ascending (d², position) runs held in registers: the device-code
// counterpart of the JAX package's in-kernel sorted-run network
// (src/repro/kernels/sorted_merge.py: tile_topk, merge_sorted_runs).
//
// On the TPU a tile's candidates are bitonic-sorted as a whole and merged
// into a VMEM run. Here each lane keeps its own KP-run in registers and
// inserts candidates one at a time (most are rejected by one compare with
// the run's tail once the run has filled); at the end a warp merges its 32
// runs. All loops over a run are unrolled with constant indices, so the run
// never leaves registers.
//
// Order: smaller d² first; ties go to the lower packed position. The empty
// slot (+inf, -1) compares as the largest position, so any real candidate
// beats it.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro_torch {

__device__ __forceinline__ bool run_before(float d, int p, float od, int op) {
  return d < od || (d == od && static_cast<unsigned>(p) < static_cast<unsigned>(op));
}

template <int KP>
__device__ __forceinline__ void run_init(float (&rd)[KP], int (&rp)[KP]) {
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    rd[j] = CUDART_INF_F;
    rp[j] = -1;
  }
}

// Insert (d, p) into the ascending run, dropping the run's largest entry.
template <int KP>
__device__ __forceinline__ void run_insert(float (&rd)[KP], int (&rp)[KP], float d, int p) {
  if (!run_before(d, p, rd[KP - 1], rp[KP - 1])) return;
  rd[KP - 1] = d;
  rp[KP - 1] = p;
#pragma unroll
  for (int j = KP - 1; j > 0; --j) {
    const bool swap = run_before(rd[j], rp[j], rd[j - 1], rp[j - 1]);
    const float lo_d = swap ? rd[j] : rd[j - 1];
    const int lo_p = swap ? rp[j] : rp[j - 1];
    const float hi_d = swap ? rd[j - 1] : rd[j];
    const int hi_p = swap ? rp[j - 1] : rp[j];
    rd[j - 1] = lo_d;
    rp[j - 1] = lo_p;
    rd[j] = hi_d;
    rp[j] = hi_p;
  }
}

// Merge the 32 runs of a warp: n_out rounds (n_out <= KP) of a butterfly
// argmin over the lanes' heads; every lane sees the same winner, the lane
// that owns it pops its head, and lane 0 writes √d² and the position of
// rank o to out_d[o] / out_p[o] (+inf, -1 for an empty slot). Positions are
// unique across the warp's lanes (each row is scanned by one lane), so the
// owner is the lane whose head has the winner's position; when the winner
// is the empty slot every lane holding one pops it, which changes nothing.
template <int KP>
__device__ __forceinline__ void warp_merge_flush(float (&rd)[KP], int (&rp)[KP], int n_out,
                                                 float* out_d, int* out_p) {
  const int lane = threadIdx.x & 31;
  for (int o = 0; o < n_out; ++o) {
    float bd = rd[0];
    int bp = rp[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (run_before(od, op, bd, bp)) {
        bd = od;
        bp = op;
      }
    }
    if (lane == 0) {
      out_d[o] = bp < 0 ? CUDART_INF_F : sqrtf(bd);
      out_p[o] = bp;
    }
    if (rp[0] == bp) {
#pragma unroll
      for (int j = 0; j + 1 < KP; ++j) {
        rd[j] = rd[j + 1];
        rp[j] = rp[j + 1];
      }
      rd[KP - 1] = CUDART_INF_F;
      rp[KP - 1] = -1;
    }
  }
}

}  // namespace repro_torch
