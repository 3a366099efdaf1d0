// Batched insertion into an ascending (key, position) run held in shared
// memory: K-D's tile form and K-Q collect the rare candidates that beat a
// run's tail and fold them in at once, with every lane of a warp busy,
// instead of inserting them one by one (or, for a few, one at a time).
//
// Order: smaller key first; ties go to the lower position, and the empty
// slot (+inf, -1) compares as the largest (run_before, csrc/sorted_run.cuh).
// Positions are unique across a run and its candidates, so the order is
// total and the merged run holds exactly the smallest entries, whatever
// order the candidates came in. Every function is called by all 32 lanes of
// a warp with warp-uniform arguments.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sorted_run.cuh"

namespace repro_torch {

// Entries of the ascending list (d, p)[0:n] that come before (a, pa).
__device__ __forceinline__ int rank_in(const float* d, const int* p, int n, float a, int pa) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run_before(d[mid], p[mid], a, pa)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge n <= 128 candidates (c_d, c_p: shared memory, in any order) into the
// ascending run lbv/posv[0:width] in place: the width smallest of both stay.
// Each entry's place in the merged run is its index in its own ordered list
// plus the entries of the other list before it: a candidate's rank in the
// run is a binary search, every other count a pass over the candidates (all
// lanes read the same candidate: a broadcast, no sort and no barrier inside).
// Run entries only move up, so the run moves 128 entries at a time from its
// end, each group read before any of it is written; the candidates go last.
__device__ __noinline__ void merge_into_run(float* lbv, int* posv, int width, const float* c_d,
                                            const int* c_p, int n, int lane) {
  float cl[4];
  int cp[4], cdest[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    cl[m] = j < n ? c_d[j] : 0.f;
    cp[m] = j < n ? c_p[j] : -1;
    cdest[m] = j < n ? rank_in(lbv, posv, width, cl[m], cp[m]) : width;
  }
  for (int i = 0; i < n; ++i) {
    const float di = c_d[i];
    const int pi = c_p[i];
#pragma unroll
    for (int m = 0; m < 4; ++m) cdest[m] += run_before(di, pi, cl[m], cp[m]) ? 1 : 0;
  }
  for (int g0 = ((width - 1) / 128) * 128; g0 >= 0; g0 -= 128) {
    float a[4];
    int pa[4], dest[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = g0 + lane + 32 * m;
      a[m] = i < width ? lbv[i] : 0.f;
      pa[m] = i < width ? posv[i] : -1;
      dest[m] = i < width ? i : width;
    }
    for (int i = 0; i < n; ++i) {
      const float di = c_d[i];
      const int pi = c_p[i];
#pragma unroll
      for (int m = 0; m < 4; ++m) dest[m] += run_before(di, pi, a[m], pa[m]) ? 1 : 0;
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (dest[m] < width) {
        lbv[dest[m]] = a[m];
        posv[dest[m]] = pa[m];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (cdest[m] < width) {
      lbv[cdest[m]] = cl[m];
      posv[cdest[m]] = cp[m];
    }
  }
  __syncwarp();
}

// Insert one (d, p) into the ascending run lbv/posv[0:width]: a ballot
// count finds its slot, the entries behind it shift one place (the last
// drops out). For the few candidates of a run that has filled.
__device__ __forceinline__ void insert_into_run(float* lbv, int* posv, int width, float d, int p,
                                                int lane) {
  int ins = 0;  // entries before the candidate form a prefix of the run
  for (int j0 = 0; j0 < width; j0 += 32) {
    const int j = j0 + lane;
    ins += __popc(__ballot_sync(0xffffffffu, j < width && run_before(lbv[j], posv[j], d, p)));
  }
  if (ins >= width) return;
  // shift [ins, width - 1) one slot right, 32 slots at a time from the end:
  // each segment reads its predecessors before any of them is overwritten
  for (int j0 = ((width - 1) / 32) * 32; j0 >= 0 && j0 + 31 >= ins; j0 -= 32) {
    const int j = j0 + lane;
    const bool write = j < width && j >= ins;
    float vd = d;
    int vp = p;
    if (write && j > ins) {
      vd = lbv[j - 1];
      vp = posv[j - 1];
    }
    __syncwarp();
    if (write) {
      lbv[j] = vd;
      posv[j] = vp;
    }
    __syncwarp();
  }
}

}  // namespace repro_torch
