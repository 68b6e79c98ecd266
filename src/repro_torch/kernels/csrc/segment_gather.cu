// Fused gather + weighted segment sum (EmbeddingBag-sum / GNN aggregation):
// out[s] = sum over segment s's entries e of w[e] * table[idx[e]].
//
// Replaces the TPU kernel repro/kernels/segment_gather.py
// segment_gather_fixed_pallas and its ragged wrapper
// segment_gather_sum_pallas.  That kernel staged one feature tile of the
// whole table in VMEM and gathered rows from it, so it fell back to its
// XLA oracle above 2^17 table rows or 32 entries per segment: at the
// sizes its users hold (a 10M-row DLRM table, a 2.4M-node GNN) it never
// ran.  Here the table stays in device memory, with no size or hotness
// bound and no fallback.
//
// Both forms take each product in the table's dtype, as the TPU kernel
// takes it (for bfloat16: the float product of two bfloat16 values is
// exact, then rounded once), sum it in float32 in entry order, and write
// each output row once, in the table's dtype.
//
// What bounds them: bytes.  Each entry reads one table row at a
// data-dependent address (from HBM or L2), and each segment writes one
// row; there is about one add per byte read.
//
// The fixed layout (segment_gather_kernel): one warp per (segment, feature
// tile).  A tile is 32 * EPL columns, lane l owning columns l, l + 32, ...
// (EPL of them), so every row read is coalesced across the warp.  The warp
// walks the segment's k (index, weight) pairs 32 at a time: each lane loads
// one pair (coalesced), then the pairs are broadcast with shuffles and four
// table rows are gathered before they are summed.  An index < 0 is padding;
// an index >= v reads row v - 1.
//
// The ragged form (segment_sum_kernel): the wrapper sorts the segment keys
// (a stable sort, so each segment's run keeps its entries' order) and finds
// each segment's run [offsets[s], offsets[s+1]) of the permutation order.
// The kernel reads order[e] and gathers indices and weights at that
// position itself, applying the reference's index rules there (a negative
// index counts from the end, then clamps into [0, V-1]): no permuted copy
// of either is written and read back.  One warp per (segment, feature
// tile) again, but a row is read as 16-byte vectors where the row length
// and the table's base allow (float32: 4 columns a lane, 128 a tile; at
// d = 100 25 lanes each carry one float4 a row), else as today's 4-byte
// columns, and 8 rows are in flight per warp.  The per-column sums are the
// fixed kernel's (same products, same float32 adds, same order), so the
// ragged output does not depend on the load path.

#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kInFlight = 4;        // rows in flight a warp, fixed layout
constexpr int kRaggedInFlight = 8;  // and ragged form
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// x * w in T: exact in float for bfloat16 inputs, then rounded once.
template <typename T>
__device__ __forceinline__ float product(float x, float w) {
  if constexpr (std::is_same<T, float>::value) {
    return x * w;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x * w));
  }
}

// The fixed layout.  It is called with offsets == nullptr; the ragged
// branch stays because on the H100 this kernel without it took 278 us, not
// 254, at the RM2 shape (tools/kernel_ab.py), for the same output bits.
template <typename T, int EPL, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
segment_gather_kernel(const T* __restrict__ table, int v, int d,
                      const int32_t* __restrict__ idx,
                      const T* __restrict__ w,
                      const int32_t* __restrict__ offsets, int k, int s,
                      int n_tiles, T* __restrict__ out) {
  const long long wid =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (wid >= static_cast<long long>(s) * n_tiles) return;
  const int lane = threadIdx.x & 31;
  const int seg = static_cast<int>(wid / n_tiles);
  const int col0 = static_cast<int>(wid - static_cast<long long>(seg) * n_tiles) *
                       (32 * EPL) + lane;
  long long lo;
  long long hi;
  if (offsets != nullptr) {
    lo = __ldg(offsets + seg);
    hi = __ldg(offsets + seg + 1);
  } else {
    lo = static_cast<long long>(seg) * k;
    hi = lo + k;
  }
  float acc[EPL];
#pragma unroll
  for (int q = 0; q < EPL; ++q) acc[q] = 0.0f;

  for (long long base = lo; base < hi; base += 32) {
    const long long e = base + lane;
    int my_idx = -1;
    float my_w = 1.0f;
    if (e < hi) {
      my_idx = __ldg(idx + e);
      if (WEIGHTED) my_w = load_f(w + e);
    }
    const int n = static_cast<int>(hi - base < 32 ? hi - base : 32);
    for (int t = 0; t < n; t += kInFlight) {
      int r[kInFlight];
      float wt[kInFlight];
      float x[kInFlight][EPL];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        r[u] = __shfl_sync(kFull, my_idx, (t + u) & 31);
        wt[u] = __shfl_sync(kFull, my_w, (t + u) & 31);
        if (t + u >= n) r[u] = -1;
        const long long row =
            static_cast<long long>(r[u] < v ? r[u] : v - 1) * d;
#pragma unroll
        for (int q = 0; q < EPL; ++q) {
          const int col = col0 + 32 * q;
          x[u][q] = (r[u] >= 0 && col < d) ? load_f(table + row + col) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (r[u] < 0) continue;  // padding, or past the run
#pragma unroll
        for (int q = 0; q < EPL; ++q) {
          acc[q] += WEIGHTED ? product<T>(x[u][q], wt[u]) : x[u][q];
        }
      }
    }
  }
  T* dst = out + static_cast<long long>(seg) * d;
#pragma unroll
  for (int q = 0; q < EPL; ++q) {
    const int col = col0 + 32 * q;
    if (col < d) store_f(dst + col, acc[q]);
  }
}

// The ragged form's row fragment: kVec, EPL consecutive columns from col0
// as one 16-byte load (the wrapper has checked d and the table's base);
// else columns col0, col0 + 32, ...  Columns past d, and rows not taken
// (on false), read as 0.
template <typename T, int EPL, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int col0,
                                         int d, bool on, float (&x)[EPL]) {
  if constexpr (kVec) {
    if (!(on && col0 < d)) {
#pragma unroll
      for (int q = 0; q < EPL; ++q) x[q] = 0.0f;
    } else if constexpr (std::is_same<T, float>::value) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row + col0));
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + col0));
      const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[2 * q] = __bfloat162float(__ushort_as_bfloat16(
            static_cast<unsigned short>(words[q] & 0xffffu)));
        x[2 * q + 1] = __bfloat162float(__ushort_as_bfloat16(
            static_cast<unsigned short>(words[q] >> 16)));
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < EPL; ++q) {
      const int col = col0 + 32 * q;
      x[q] = (on && col < d) ? load_f(row + col) : 0.0f;
    }
  }
}

template <typename T, int EPL, bool kVec>
__device__ __forceinline__ void store_row(T* __restrict__ dst, int col0, int d,
                                          const float (&acc)[EPL]) {
  if constexpr (kVec) {
    if (col0 >= d) return;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(dst + col0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      unsigned words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        words[q] = static_cast<unsigned>(__bfloat16_as_ushort(
                       __float2bfloat16_rn(acc[2 * q]))) |
                   (static_cast<unsigned>(__bfloat16_as_ushort(
                        __float2bfloat16_rn(acc[2 * q + 1])))
                    << 16);
      }
      *reinterpret_cast<uint4*>(dst + col0) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < EPL; ++q) {
      const int col = col0 + 32 * q;
      if (col < d) store_f(dst + col, acc[q]);
    }
  }
}

template <typename T, int EPL, bool kVec, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ table, int v, int d,
                   const int32_t* __restrict__ indices,
                   const T* __restrict__ w,
                   const long long* __restrict__ order,
                   const int32_t* __restrict__ offsets, int s, int n_tiles,
                   T* __restrict__ out) {
  const long long wid =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (wid >= static_cast<long long>(s) * n_tiles) return;
  const int lane = threadIdx.x & 31;
  const int seg = static_cast<int>(wid / n_tiles);
  const int tile = static_cast<int>(wid - static_cast<long long>(seg) * n_tiles);
  const int col0 = tile * (32 * EPL) + (kVec ? lane * EPL : lane);
  const long long lo = __ldg(offsets + seg);
  const long long hi = __ldg(offsets + seg + 1);
  float acc[EPL];
#pragma unroll
  for (int q = 0; q < EPL; ++q) acc[q] = 0.0f;

  for (long long base = lo; base < hi; base += 32) {
    // each lane one entry of the run: its position in the permutation,
    // then its index (the reference's rules) and weight gathered there
    const long long e = base + lane;
    int my_idx = 0;
    float my_w = 1.0f;
    if (e < hi) {
      const long long p = __ldg(order + e);
      int i = __ldg(indices + p);
      if (i < 0) i += v;
      my_idx = repro::clampi(i, 0, v - 1);
      if (WEIGHTED) my_w = load_f(w + p);
    }
    const int n = static_cast<int>(hi - base < 32 ? hi - base : 32);
    for (int t = 0; t < n; t += kRaggedInFlight) {
      float wt[kRaggedInFlight];
      float x[kRaggedInFlight][EPL];
#pragma unroll
      for (int u = 0; u < kRaggedInFlight; ++u) {
        const int r = __shfl_sync(kFull, my_idx, (t + u) & 31);
        wt[u] = __shfl_sync(kFull, my_w, (t + u) & 31);
        load_row<T, EPL, kVec>(table + static_cast<long long>(r) * d, col0, d,
                               t + u < n, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kRaggedInFlight; ++u) {
        if (t + u >= n) continue;  // past the run
#pragma unroll
        for (int q = 0; q < EPL; ++q) {
          acc[q] += WEIGHTED ? product<T>(x[u][q], wt[u]) : x[u][q];
        }
      }
    }
  }
  store_row<T, EPL, kVec>(out + static_cast<long long>(seg) * d, col0, d, acc);
}

template <typename T, int EPL>
cudaError_t launch_fixed(const void* table, int v, int d, const void* idx,
                         const void* w, int k, int s, void* out,
                         cudaStream_t st) {
  const int n_tiles = (d + 32 * EPL - 1) / (32 * EPL);
  const unsigned blocks = repro::blocks_for(
      static_cast<long long>(s) * n_tiles, kWarpsPerBlock);
  const T* tb = static_cast<const T*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (w != nullptr) {
    segment_gather_kernel<T, EPL, true><<<blocks, kThreads, 0, st>>>(
        tb, v, d, ix, wt, nullptr, k, s, n_tiles, o);
  } else {
    segment_gather_kernel<T, EPL, false><<<blocks, kThreads, 0, st>>>(
        tb, v, d, ix, wt, nullptr, k, s, n_tiles, o);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fixed_dtype(const void* table, int v, int d, const void* idx,
                        const void* w, int k, int s, void* out,
                        cudaStream_t st) {
  if (d <= 32) return launch_fixed<T, 1>(table, v, d, idx, w, k, s, out, st);
  if (d <= 64) return launch_fixed<T, 2>(table, v, d, idx, w, k, s, out, st);
  return launch_fixed<T, 4>(table, v, d, idx, w, k, s, out, st);
}

template <typename T, int EPL, bool kVec>
cudaError_t launch_sum(const void* table, int v, int d, const void* indices,
                       const void* w, const void* order, const void* offsets,
                       int s, void* out, cudaStream_t st) {
  const int n_tiles = (d + 32 * EPL - 1) / (32 * EPL);
  const unsigned blocks = repro::blocks_for(
      static_cast<long long>(s) * n_tiles, kWarpsPerBlock);
  const T* tb = static_cast<const T*>(table);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const T* wt = static_cast<const T*>(w);
  const long long* od = static_cast<const long long*>(order);
  const int32_t* of = static_cast<const int32_t*>(offsets);
  T* o = static_cast<T*>(out);
  if (w != nullptr) {
    segment_sum_kernel<T, EPL, kVec, true><<<blocks, kThreads, 0, st>>>(
        tb, v, d, ix, wt, od, of, s, n_tiles, o);
  } else {
    segment_sum_kernel<T, EPL, kVec, false><<<blocks, kThreads, 0, st>>>(
        tb, v, d, ix, wt, od, of, s, n_tiles, o);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t sum_dtype(const void* table, int v, int d, int vec,
                      const void* indices, const void* w, const void* order,
                      const void* offsets, int s, void* out,
                      cudaStream_t st) {
  constexpr int kVecCols = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    if (d % kVecCols != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0) {
      return cudaErrorInvalidValue;
    }
    return launch_sum<T, kVecCols, true>(table, v, d, indices, w, order,
                                         offsets, s, out, st);
  }
  if (d <= 32) {
    return launch_sum<T, 1, false>(table, v, d, indices, w, order, offsets, s,
                                   out, st);
  }
  if (d <= 64) {
    return launch_sum<T, 2, false>(table, v, d, indices, w, order, offsets, s,
                                   out, st);
  }
  return launch_sum<T, 4, false>(table, v, d, indices, w, order, offsets, s,
                                 out, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table, weights and out alike).
// w == nullptr: every weight is 1.

// The fixed layout: idx int32 [s, k].
REPRO_EXPORT int repro_segment_gather(const void* table, int v, int d,
                                      int dtype, const void* idx,
                                      const void* w, int k, int s, void* out,
                                      void* stream) {
  if (v <= 0 || d <= 0 || s < 0 || k < 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? fixed_dtype<float>(table, v, d, idx, w, k, s, out, st)
          : fixed_dtype<__nv_bfloat16>(table, v, d, idx, w, k, s, out, st);
  return static_cast<int>(err);
}

// The ragged form: segment i's entries are order[offsets[i], offsets[i+1])
// (int64 positions into indices and w; offsets int32 [s + 1]).  vec: rows
// as 16-byte loads (d a multiple of 16 / sizeof(T), table 16-byte aligned).
REPRO_EXPORT int repro_segment_gather_sum(const void* table, int v, int d,
                                          int dtype, int vec,
                                          const void* indices, const void* w,
                                          const void* order,
                                          const void* offsets, int s,
                                          void* out, void* stream) {
  if (v <= 0 || d <= 0 || s < 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? sum_dtype<float>(table, v, d, vec, indices, w, order,
                                    offsets, s, out, st)
                 : sum_dtype<__nv_bfloat16>(table, v, d, vec, indices, w,
                                            order, offsets, s, out, st);
  return static_cast<int>(err);
}
