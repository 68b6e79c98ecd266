// Batched IsJoinable probe: out[i] = target[i] in nbr[lo[i] : hi[i]).
//
// Replaces the TPU kernel repro/kernels/edge_exists.py edge_exists_pallas,
// which staged the adjacency array in VMEM and ran n_iters fixed halving
// rounds in every lane.  On Hopper the adjacency stays in device memory and
// the probe is bound by latency of dependent loads: each probe reads
// lo/hi/target, then about log2(deg) scattered adjacency words one after the
// other.  One thread per probe runs a true lower bound that stops when its
// range is empty, so short adjacency runs finish early; the executor sizes
// n_iters to cover the largest degree, so the answer equals the
// fixed-round reference.  The top levels of every search hit the same few
// lines, which L2 keeps.

#include "common.cuh"

namespace {

__global__ void edge_exists_kernel(const int32_t* __restrict__ nbr,
                                   const int32_t* __restrict__ lo,
                                   const int32_t* __restrict__ hi,
                                   const int32_t* __restrict__ target,
                                   bool* __restrict__ out, int n, int m,
                                   int n_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lo0 = __ldg(lo + i);
  const int hi0 = __ldg(hi + i);
  const int t = __ldg(target + i);
  int l = lo0;
  int h = hi0;
  for (int it = 0; it < n_iters && l < h; ++it) {
    const int mid = (l + h) >> 1;
    if (__ldg(nbr + repro::clampi(mid, 0, m - 1)) < t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  out[i] = lo0 < hi0 && l < hi0 &&
           __ldg(nbr + repro::clampi(l, 0, m - 1)) == t;
}

}  // namespace

REPRO_EXPORT int repro_edge_exists(const void* nbr, const void* lo,
                                   const void* hi, const void* target,
                                   void* out, int n, int m, int n_iters,
                                   void* stream) {
  constexpr int kThreads = 256;
  edge_exists_kernel<<<repro::blocks_for(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(target),
      static_cast<bool*>(out), n, m, n_iters);
  return static_cast<int>(cudaGetLastError());
}
