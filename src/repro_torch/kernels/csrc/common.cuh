// Shared device helpers for the repro_torch Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns cudaGetLastError() as an int, so the ctypes
// wrapper in repro_torch/kernels/ops.py can raise on a refused launch.
// Bitmaps, masks and signatures arrive as int32 bit patterns of the
// reference's uint32 words; `&` and `==` on them are bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// (row & req) == req over w words: the packed-bitmap superset test.
__device__ __forceinline__ bool superset(const int32_t* __restrict__ row,
                                         const int32_t* __restrict__ req,
                                         int w) {
  bool ok = true;
  for (int k = 0; k < w; ++k) {
    const int32_t r = __ldg(req + k);
    ok &= (__ldg(row + k) & r) == r;
  }
  return ok;
}

// Is t in the sorted slice nbr[lo0, hi0)?  A lower-bound binary search of
// at most n_iters halving rounds that stops once its range is empty; the
// reference runs exactly n_iters rounds, and the rounds after the range
// empties change nothing it reports, so the two agree for every n_iters.
// Indices clamp into [0, m) as the reference's gathers do.  The midpoint is
// l + (h - l) / 2: l + h overflows int once a range lies past offset 2^30
// (an adjacency of 1.23e9 words holds such ranges).
__device__ __forceinline__ bool sorted_contains(const int32_t* __restrict__ nbr,
                                                int m, int lo0, int hi0,
                                                int t, int n_iters) {
  int l = lo0;
  int h = hi0;
  for (int it = 0; it < n_iters && l < h; ++it) {
    const int mid = l + ((h - l) >> 1);
    if (__ldg(nbr + clampi(mid, 0, m - 1)) < t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return lo0 < hi0 && l < hi0 && __ldg(nbr + clampi(l, 0, m - 1)) == t;
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace repro
