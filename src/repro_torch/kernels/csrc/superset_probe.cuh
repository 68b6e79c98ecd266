// The packed-bitmap superset probe shared by signature_filter.cu and
// bitmap_superset.cu:
//
//   out[i] = (row_i & req) == req over the row's words, where
//   row_i  = table[clamp(ids[i], 0, n_rows - 1)]   (the gather form), or
//   row_i  = table[i]                               (ids == nullptr).
//
// It is bound by bytes moved in 32-byte sectors: per probe it reads a 4-byte
// id, one row of W words (at a data-dependent place for the gather form)
// and writes one byte.  A random gather is only as fast as the number of
// gathers in flight, so the design raises memory-level parallelism and
// widens every access:
//
//   * a thread takes 4 consecutive ids with one 16-byte load; a scalar head
//     and tail handle ids that are not 16-byte aligned (a v[1:] view) and
//     n % 4.  Without ids a thread takes 4 consecutive rows, read as W
//     16-byte loads (4 rows of W 4-byte words) where the table is 16-byte
//     aligned and W is at most 4 words of 4 or 8 bytes;
//   * the 4 rows are gathered together, 4 independent loads in flight per
//     thread, each pair of row words as one 8-byte load (the launcher takes
//     the 4-byte path when the table is not 8-byte aligned or a row has an
//     odd number of words);
//   * req is read once per thread, into registers for rows of at most 4
//     words, into shared memory beyond;
//   * the 4 results are stored as one 32-bit word (the wrapper places out so
//     that the word of the first aligned id group is 4-byte aligned);
//   * the grid is 8 blocks of 256 threads per SM, one wave, walking the
//     groups with a grid-stride loop.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace probe {

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

// Word idx of a run of 16-byte registers (idx is a constant once unrolled).
template <typename Word>
__device__ __forceinline__ Word word_at(const uint4* buf, int idx);

template <>
__device__ __forceinline__ unsigned word_at<unsigned>(const uint4* buf,
                                                      int idx) {
  const uint4& b = buf[idx >> 2];
  switch (idx & 3) {
    case 0: return b.x;
    case 1: return b.y;
    case 2: return b.z;
    default: return b.w;
  }
}

template <>
__device__ __forceinline__ uint2 word_at<uint2>(const uint4* buf, int idx) {
  const uint4& b = buf[idx >> 1];
  return (idx & 1) ? make_uint2(b.z, b.w) : make_uint2(b.x, b.y);
}

// Rows of kNw words of type Word (kNw > 0: req in registers) or of nw words
// (kNw == 0: req in shared memory).  rows16: the table is 16-byte aligned
// (read only without ids).
template <typename Word, int kNw>
__global__ void __launch_bounds__(kThreads)
superset_probe_kernel(const Word* __restrict__ table,
                      const int32_t* __restrict__ ids,
                      const Word* __restrict__ req, bool* __restrict__ out,
                      int n, int head, int n_rows, int nw_runtime,
                      bool rows16) {
  const int nw = kNw > 0 ? kNw : nw_runtime;
  const bool gather = ids != nullptr;
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
    return table +
           static_cast<long long>(repro::clampi(id, 0, n_rows - 1)) * nw;
  };

  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int n_vec = (n - head) >> 2;
  const int tail = head + 4 * n_vec;
  // the scalar head (ids before the first 16-byte boundary) and tail
  for (int part = 0; part < 2; ++part) {
    const int i = part == 0 ? (gtid < head ? gtid : -1)
                            : (gtid < n - tail ? tail + gtid : -1);
    if (i < 0) continue;
    const Word* row = row_of(gather ? __ldg(ids + i) : i);
    bool ok = true;
    for (int kw = 0; kw < nw; ++kw) ok &= covers(__ldg(row + kw), req_word(kw));
    out[i] = ok;
  }

  const int4* ids4 = reinterpret_cast<const int4*>(ids + head);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(out + head);
  for (int q = gtid; q < n_vec; q += gridDim.x * kThreads) {
    bool ok[4] = {true, true, true, true};
    bool done = false;
    if constexpr (kNw > 0) {
      if (!gather && rows16) {
        // 4 consecutive rows (head is 0 here): kNw 16-byte loads of 4-byte
        // words, 2 * kNw of 8-byte words
        constexpr int kU4 = kNw * static_cast<int>(sizeof(Word)) / 4;
        const uint4* src = reinterpret_cast<const uint4*>(
            table + static_cast<long long>(4 * q) * kNw);
        uint4 buf[kU4];
#pragma unroll
        for (int u = 0; u < kU4; ++u) buf[u] = __ldg(src + u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int kw = 0; kw < kNw; ++kw) {
            ok[j] &= covers(word_at<Word>(buf, j * kNw + kw), rq[kw]);
          }
        }
        done = true;
      }
    }
    if (!done) {
      const int first = head + 4 * q;
      const int4 id4 = gather ? __ldg(ids4 + q)
                              : make_int4(first, first + 1, first + 2,
                                          first + 3);
      const Word* rows[4] = {row_of(id4.x), row_of(id4.y), row_of(id4.z),
                             row_of(id4.w)};
#pragma unroll
      for (int kw = 0; kw < nw; ++kw) {
        Word got[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) got[j] = __ldg(rows[j] + kw);
        const Word r = req_word(kw);
#pragma unroll
        for (int j = 0; j < 4; ++j) ok[j] &= covers(got[j], r);
      }
    }
    o4[q] = static_cast<uint32_t>(ok[0]) | (static_cast<uint32_t>(ok[1]) << 8) |
            (static_cast<uint32_t>(ok[2]) << 16) |
            (static_cast<uint32_t>(ok[3]) << 24);
  }
}

inline int sm_count() {
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
cudaError_t launch_words(const void* table, const void* ids, const void* req,
                         void* out, int n, int head, int n_rows, int nw,
                         bool rows16, cudaStream_t st) {
  const long long n_vec = (n - head) / 4;
  const unsigned grid = static_cast<unsigned>(
      std::max(1LL, std::min(static_cast<long long>(repro::blocks_for(
                                 n_vec, kThreads)),
                             static_cast<long long>(sm_count()) *
                                 kBlocksPerSm)));
  superset_probe_kernel<Word, kNw><<<grid, kThreads, 0, st>>>(
      static_cast<const Word*>(table), static_cast<const int32_t*>(ids),
      static_cast<const Word*>(req), static_cast<bool*>(out), n, head, n_rows,
      nw, rows16);
  return cudaGetLastError();
}

template <typename Word>
cudaError_t launch_width(const void* table, const void* ids, const void* req,
                         void* out, int n, int head, int n_rows, int nw,
                         bool rows16, cudaStream_t st) {
  switch (nw) {
    case 1:
      return launch_words<Word, 1>(table, ids, req, out, n, head, n_rows, 1,
                                   rows16, st);
    case 2:
      return launch_words<Word, 2>(table, ids, req, out, n, head, n_rows, 2,
                                   rows16, st);
    case 3:
      return launch_words<Word, 3>(table, ids, req, out, n, head, n_rows, 3,
                                   rows16, st);
    case 4:
      return launch_words<Word, 4>(table, ids, req, out, n, head, n_rows, 4,
                                   rows16, st);
    default:
      return launch_words<Word, 0>(table, ids, req, out, n, head, n_rows, nw,
                                   false, st);
  }
}

// The C entry of both kernels.  table: n_rows rows of w int32 words; ids:
// n int32 row ids, or nullptr to probe rows 0..n-1 (n <= n_rows).  wide !=
// 0: rows are read as 8-byte words (table 8-byte aligned, w even).  out +
// head must be 4-byte aligned, head being the number of ids before the
// first 16-byte boundary of ids (0 without ids).
inline int launch(const void* table, const void* ids, const void* req,
                  void* out, int n, int n_rows, int w, int wide,
                  void* stream) {
  const uintptr_t vp = reinterpret_cast<uintptr_t>(ids);
  const uintptr_t tp = reinterpret_cast<uintptr_t>(table);
  const int head =
      ids ? std::min<int>(n, static_cast<int>((16 - vp % 16) % 16) / 4) : 0;
  if (n <= 0 || n_rows <= 0 || w < 0 || vp % 4 != 0 ||
      (!ids && n > n_rows) ||
      (n - head >= 4 && (reinterpret_cast<uintptr_t>(out) + head) % 4 != 0) ||
      (wide && (w % 2 != 0 || tp % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rows16 = !ids && tp % 16 == 0;
  cudaError_t err =
      wide ? launch_width<uint2>(table, ids, req, out, n, head, n_rows, w / 2,
                                 rows16, st)
           : launch_width<unsigned>(table, ids, req, out, n, head, n_rows, w,
                                    rows16, st);
  return static_cast<int>(err);
}

}  // namespace probe
}  // namespace repro
