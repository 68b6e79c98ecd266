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
  out[i] = repro::sorted_contains(nbr, m, __ldg(lo + i), __ldg(hi + i),
                                  __ldg(target + i), n_iters);
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
