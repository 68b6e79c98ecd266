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

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace repro
