// Neighborhood-signature prune probe: out[i] = superset(sig[clamp(v[i])], req).
//
// Replaces the TPU kernel repro/kernels/signature_filter.py
// signature_filter_pallas, which kept the whole [V, 2W] table resident in
// VMEM and gathered rows from it.  On Hopper the table stays in device
// memory and the probe is bound by bytes: one candidate id read, one 2W-word
// row gathered and one byte written per candidate.  The gathered rows are
// scattered, so a thread owns one candidate and reads its row through the
// read-only path; the hot part of the table stays in the 50 MB L2.

#include "common.cuh"

namespace {

__global__ void signature_filter_kernel(const int32_t* __restrict__ sig,
                                        const int32_t* __restrict__ v,
                                        const int32_t* __restrict__ req,
                                        bool* __restrict__ out, int n,
                                        int n_rows, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = repro::clampi(__ldg(v + i), 0, n_rows - 1);
  out[i] = repro::superset(sig + static_cast<long long>(r) * w, req, w);
}

}  // namespace

REPRO_EXPORT int repro_signature_filter(const void* sig, const void* v,
                                        const void* req, void* out, int n,
                                        int n_rows, int w, void* stream) {
  constexpr int kThreads = 256;
  signature_filter_kernel<<<repro::blocks_for(n, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sig), static_cast<const int32_t*>(v),
      static_cast<const int32_t*>(req), static_cast<bool*>(out), n, n_rows,
      w);
  return static_cast<int>(cudaGetLastError());
}
