// Neighborhood-signature prune probe: out[i] = superset(sig[clamp(v[i])], req).
//
// Replaces the TPU kernel repro/kernels/signature_filter.py
// signature_filter_pallas, which kept the whole [V, 2W] table resident in
// VMEM and gathered rows from it.  On Hopper the table stays in device
// memory (it is tens of megabytes at LUBM 1000) and the probe is bound by
// bytes moved in 32-byte sectors: per candidate it reads a 4-byte id,
// gathers one 8W-byte row at a data-dependent place (a whole sector for a
// row of 2 words) and writes one byte.  A random gather is only as fast as
// the number of gathers in flight, so the design raises memory-level
// parallelism and widens every access:
//
//   * a thread takes 4 consecutive ids with one 16-byte load; a scalar head
//     and tail handle a v that is not 16-byte aligned (a v[1:] view) and
//     n % 4;
//   * it gathers the 4 rows together, 4 independent loads in flight per
//     thread, each pair of row words as one 8-byte load (a row of 2W words
//     is W loads; the wrapper takes the 4-byte path when sig is not 8-byte
//     aligned or a row has an odd number of words);
//   * req is read once per thread, into registers for W <= 4 (every folded
//     signature: at most 128 bits a direction), into shared memory beyond;
//   * the 4 results are stored as one 32-bit word (the wrapper places out so
//     that the word of the first aligned id group is 4-byte aligned);
//   * the grid is 8 blocks of 256 threads per SM, one wave, walking the id
//     groups with a grid-stride loop.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kReqShared = 512;  // req words kept in shared memory
constexpr int kMaxDevices = 64;

__device__ __forceinline__ bool covers(uint2 a, uint2 r) {
  return ((a.x & r.x) == r.x) & ((a.y & r.y) == r.y);
}

__device__ __forceinline__ bool covers(unsigned a, unsigned r) {
  return (a & r) == r;
}

// Rows of kNw words of type Word (kNw > 0: req in registers) or of nw words
// (kNw == 0: req in shared memory).
template <typename Word, int kNw>
__global__ void __launch_bounds__(kThreads)
signature_filter_kernel(const Word* __restrict__ sig,
                        const int32_t* __restrict__ v,
                        const Word* __restrict__ req, bool* __restrict__ out,
                        int n, int head, int n_rows, int nw_runtime) {
  const int nw = kNw > 0 ? kNw : nw_runtime;
  Word rq[kNw > 0 ? kNw : 1];
  __shared__ Word s_req[kNw > 0 ? 1 : kReqShared];
  if constexpr (kNw > 0) {
#pragma unroll
    for (int kw = 0; kw < kNw; ++kw) rq[kw] = __ldg(req + kw);
  } else {
    for (int kw = threadIdx.x; kw < min(nw, kReqShared); kw += kThreads) {
      s_req[kw] = __ldg(req + kw);
    }
    __syncthreads();
  }
  auto req_word = [&](int kw) -> Word {
    if constexpr (kNw > 0) {
      return rq[kw];
    } else {
      return kw < kReqShared ? s_req[kw] : __ldg(req + kw);
    }
  };
  auto row_of = [&](int id) {
    return sig + static_cast<long long>(repro::clampi(id, 0, n_rows - 1)) * nw;
  };

  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int n_vec = (n - head) >> 2;
  const int tail = head + 4 * n_vec;
  // the scalar head (ids before the first 16-byte boundary) and tail
  for (int part = 0; part < 2; ++part) {
    const int i = part == 0 ? (gtid < head ? gtid : -1)
                            : (gtid < n - tail ? tail + gtid : -1);
    if (i < 0) continue;
    const Word* row = row_of(__ldg(v + i));
    bool ok = true;
    for (int kw = 0; kw < nw; ++kw) ok &= covers(__ldg(row + kw), req_word(kw));
    out[i] = ok;
  }

  const int4* v4 = reinterpret_cast<const int4*>(v + head);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(out + head);
  for (int q = gtid; q < n_vec; q += gridDim.x * kThreads) {
    const int4 ids = __ldg(v4 + q);
    const Word* rows[4] = {row_of(ids.x), row_of(ids.y), row_of(ids.z),
                           row_of(ids.w)};
    bool ok[4] = {true, true, true, true};
#pragma unroll
    for (int kw = 0; kw < nw; ++kw) {
      Word got[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) got[j] = __ldg(rows[j] + kw);
      const Word r = req_word(kw);
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[j] &= covers(got[j], r);
    }
    o4[q] = static_cast<uint32_t>(ok[0]) | (static_cast<uint32_t>(ok[1]) << 8) |
            (static_cast<uint32_t>(ok[2]) << 16) |
            (static_cast<uint32_t>(ok[3]) << 24);
  }
}

int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 132;
  }
  if (counts[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = c > 0 ? c : 132;
  }
  return counts[dev];
}

template <typename Word, int kNw>
cudaError_t launch(const void* sig, const void* v, const void* req, void* out,
                   int n, int head, int n_rows, int nw, cudaStream_t st) {
  const long long n_vec = (n - head) / 4;
  const unsigned grid = static_cast<unsigned>(
      std::max(1LL, std::min(static_cast<long long>(repro::blocks_for(
                                 n_vec, kThreads)),
                             static_cast<long long>(sm_count()) *
                                 kBlocksPerSm)));
  signature_filter_kernel<Word, kNw><<<grid, kThreads, 0, st>>>(
      static_cast<const Word*>(sig), static_cast<const int32_t*>(v),
      static_cast<const Word*>(req), static_cast<bool*>(out), n, head, n_rows,
      nw);
  return cudaGetLastError();
}

}  // namespace

// w: int32 words per row.  wide != 0: rows are read as 8-byte words (sig
// 8-byte aligned, w even).  out + head must be 4-byte aligned, head being
// the number of ids before v's first 16-byte boundary.
REPRO_EXPORT int repro_signature_filter(const void* sig, const void* v,
                                        const void* req, void* out, int n,
                                        int n_rows, int w, int wide,
                                        void* stream) {
  const uintptr_t vp = reinterpret_cast<uintptr_t>(v);
  const int head = std::min<int>(n, static_cast<int>((16 - vp % 16) % 16) / 4);
  if (n <= 0 || n_rows <= 0 || w <= 0 || vp % 4 != 0 ||
      (n - head >= 4 && (reinterpret_cast<uintptr_t>(out) + head) % 4 != 0) ||
      (wide && (w % 2 != 0 || reinterpret_cast<uintptr_t>(sig) % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!wide) {
    err = launch<unsigned, 0>(sig, v, req, out, n, head, n_rows, w, st);
  } else {
    switch (w / 2) {
      case 1:
        err = launch<uint2, 1>(sig, v, req, out, n, head, n_rows, 1, st);
        break;
      case 2:
        err = launch<uint2, 2>(sig, v, req, out, n, head, n_rows, 2, st);
        break;
      case 3:
        err = launch<uint2, 3>(sig, v, req, out, n, head, n_rows, 3, st);
        break;
      case 4:
        err = launch<uint2, 4>(sig, v, req, out, n, head, n_rows, 4, st);
        break;
      default:
        err = launch<uint2, 0>(sig, v, req, out, n, head, n_rows, w / 2, st);
    }
  }
  return static_cast<int>(err);
}
