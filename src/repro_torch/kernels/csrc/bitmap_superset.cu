// Row-wise packed-bitmap superset test: out[i] = (bitmap[i] & req) == req.
//
// Replaces the TPU kernel repro/kernels/bitmap_filter.py
// bitmap_superset_pallas (a VPU pass per row tile).  On Hopper it is bound
// by bytes: each row's W words are read once and one byte is written, with
// no reuse.  One thread per row walks its W words (W is a few words for
// real ontologies); neighbouring threads read neighbouring rows, so a warp's
// loads cover one contiguous span of 32*W words.

#include "common.cuh"

namespace {

__global__ void bitmap_superset_kernel(const int32_t* __restrict__ bitmap,
                                       const int32_t* __restrict__ req,
                                       bool* __restrict__ out, int n, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = repro::superset(bitmap + static_cast<long long>(i) * w, req, w);
}

}  // namespace

REPRO_EXPORT int repro_bitmap_superset(const void* bitmap, const void* req,
                                       void* out, int n, int w,
                                       void* stream) {
  constexpr int kThreads = 256;
  bitmap_superset_kernel<<<repro::blocks_for(n, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bitmap), static_cast<const int32_t*>(req),
      static_cast<bool*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}
