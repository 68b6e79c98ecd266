// +INT bulk join: out[i, j] = a[i, j] in b[i, :]; a negative a never matches.
//
// Replaces the TPU kernel repro/kernels/sorted_intersect.py
// tile_membership_pallas, which evaluated the TA x TB equality cube on the
// VPU per row tile.  On Hopper it is bound by bytes: the executor calls it
// with TA = 1 and TB = pow2(max degree) <= 128, so each row reads TB words
// once and does TB compares.  One warp owns one row: the lanes stride over
// b[i, :] with coalesced loads, and one __any_sync per a[i, j] gives the
// answer without shared memory.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void tile_membership_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ b,
                                       bool* __restrict__ out, int rows,
                                       int ta, int tb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int32_t* brow = b + static_cast<long long>(row) * tb;
  const int32_t* arow = a + static_cast<long long>(row) * ta;
  for (int j = 0; j < ta; ++j) {
    const int32_t x = __ldg(arow + j);
    bool hit = false;
    for (int k = lane; k < tb; k += 32) hit |= __ldg(brow + k) == x;
    const bool any = __any_sync(0xffffffffu, hit);
    if (lane == 0) out[static_cast<long long>(row) * ta + j] = any && x >= 0;
  }
}

}  // namespace

REPRO_EXPORT int repro_tile_membership(const void* a, const void* b,
                                       void* out, int rows, int ta, int tb,
                                       void* stream) {
  tile_membership_kernel<<<repro::blocks_for(rows, kWarpsPerBlock),
                           kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<bool*>(out), rows, ta, tb);
  return static_cast<int>(cudaGetLastError());
}
