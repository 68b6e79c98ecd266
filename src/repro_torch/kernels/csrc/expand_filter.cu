// Fused ragged CSR expansion + bitmap superset filter + order-preserving
// compaction: the executor's per-step hot path.
//
// Replaces the TPU kernel repro/kernels/expand_filter.py
// expand_filter_compact_pallas.  That kernel walks output tiles in a
// sequential grid, sorts each tile's survivors to its front, and appends
// the tile at a running base carried across grid steps in SMEM.  Hopper's
// blocks run in parallel and in no order, so nothing can be carried from
// one block to the next; the compaction becomes a three-pass block scan:
//
//   1. count: one thread per output slot k < capacity maps k to its row by
//      an upper-bound search on the exclusive cumsum `offs`, gathers
//      v = nbr[start[row] + j], tests (bitmap[v] & mask) == mask and the
//      bound id, and each block counts its survivors (warp ballot + popc);
//   2. scan: one block turns the per-block counts (at most 2^22 / 1024 of
//      them) into exclusive block bases in place and writes the total count;
//   3. scatter: the slots are evaluated again and each survivor is written
//      at block base + rank in block (warp ballot + shared warp offsets),
//      which keeps stream order; slots at or past the count are set to -1.
//
// What bounds it: the scattered gathers.  Each surviving slot reads one
// adjacency word and W bitmap words at data-dependent addresses, so the
// kernel is bound by bytes moved in sectors, not by operations; passes 1
// and 3 each pay the offs search and the gathers, which the hot rows of
// `offs`, `nbr` and the bitmap mostly serve from L2.  The count stays on
// the device: the executor never reads it back inside a chunk.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCapacity = 1 << 22;
constexpr int kMaxBlocks = kMaxCapacity / kThreads;
constexpr int kScanItems = kMaxBlocks / kThreads;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* nbr;
  const int32_t* bitmap;
  const int32_t* start;
  const int32_t* deg;
  const int32_t* offs;
  const int32_t* mask;
  int m;           // adjacency length
  int n_vertices;  // bitmap rows
  int w;           // bitmap words per row
  int r_rows;      // input rows
  int bound_id;    // < 0: no check
  int capacity;
};

struct Slot {
  bool ok;
  int v;
  int row;
};

__device__ __forceinline__ Slot eval_slot(const Args& a, int k) {
  Slot s{false, -1, -1};
  if (k >= a.capacity) return s;
  // row = rightmost i with offs[i] <= k
  int lo = 0;
  int hi = a.r_rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.offs + mid) <= k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int row = repro::clampi(lo - 1, 0, a.r_rows - 1);
  const int j = k - __ldg(a.offs + row);
  const long long total = static_cast<long long>(__ldg(a.offs + a.r_rows - 1)) +
                          __ldg(a.deg + a.r_rows - 1);
  const bool valid = k < total && j >= 0 && j < __ldg(a.deg + row);
  s.row = row;
  if (!valid) return s;
  const int v = __ldg(a.nbr + repro::clampi(__ldg(a.start + row) + j, 0, a.m - 1));
  s.v = v;
  const int vs = repro::clampi(v, 0, a.n_vertices - 1);
  s.ok = repro::superset(a.bitmap + static_cast<long long>(vs) * a.w, a.mask,
                         a.w) &&
         (a.bound_id < 0 || v == a.bound_id);
  return s;
}

// Rank of this thread's flag among the block's set flags (in thread order),
// and the block's total.  Every thread of the block must call it.
__device__ __forceinline__ int block_rank(bool ok, int* warp_sums,
                                          int* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, ok);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int own = warp_sums[lane];
    int x = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    warp_sums[lane] = x - own;  // exclusive warp offsets
    if (lane == 31) warp_sums[kWarps] = x;
  }
  __syncthreads();
  *block_total = warp_sums[kWarps];
  return warp_sums[warp] + in_warp;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Args a, int* __restrict__ block_counts) {
  __shared__ int warp_sums[kWarps + 1];
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const Slot s = eval_slot(a, k);
  int total;
  block_rank(s.ok, warp_sums, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// In-place exclusive scan of n_blocks (<= kMaxBlocks) counts by one block.
__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, int n_blocks, int* __restrict__ count_out) {
  __shared__ int warp_sums[kWarps + 1];
  const int first = threadIdx.x * kScanItems;
  int items[kScanItems];
  int local = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    items[i] = first + i < n_blocks ? counts[first + i] : 0;
    local += items[i];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int own = warp_sums[lane];
    int z = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, z, o);
      if (lane >= o) z += y;
    }
    warp_sums[lane] = z - own;
    if (lane == 31) warp_sums[kWarps] = z;
  }
  __syncthreads();
  int run = warp_sums[warp] + x - local;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (first + i < n_blocks) counts[first + i] = run;
    run += items[i];
  }
  if (threadIdx.x == 0) *count_out = warp_sums[kWarps];
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(Args a, const int* __restrict__ block_base,
               const int* __restrict__ count, int* __restrict__ v_out,
               int* __restrict__ row_out) {
  __shared__ int warp_sums[kWarps + 1];
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const Slot s = eval_slot(a, k);
  int total;
  const int rank = block_rank(s.ok, warp_sums, &total);
  if (s.ok) {
    const int dst = block_base[blockIdx.x] + rank;
    v_out[dst] = s.v;
    row_out[dst] = s.row;
  }
  if (k < a.capacity && k >= *count) {
    v_out[k] = -1;
    row_out[k] = -1;
  }
}

}  // namespace

// scratch: int32 [ceil(capacity / 1024)] block counts, turned into bases.
REPRO_EXPORT int repro_expand_filter_compact(
    const void* nbr, int m, const void* bitmap, int n_vertices, int w,
    const void* start, const void* deg, const void* offs, int r_rows,
    const void* mask, int bound_id, int capacity, void* v_out, void* row_out,
    void* count_out, void* scratch, void* stream) {
  if (capacity <= 0 || capacity > kMaxCapacity || r_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(nbr), static_cast<const int32_t*>(bitmap),
         static_cast<const int32_t*>(start), static_cast<const int32_t*>(deg),
         static_cast<const int32_t*>(offs), static_cast<const int32_t*>(mask),
         m, n_vertices, w, r_rows, bound_id, capacity};
  const unsigned n_blocks = repro::blocks_for(capacity, kThreads);
  int* counts = static_cast<int*>(scratch);
  int* cnt = static_cast<int*>(count_out);
  count_kernel<<<n_blocks, kThreads, 0, st>>>(a, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kThreads, 0, st>>>(counts, static_cast<int>(n_blocks), cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<n_blocks, kThreads, 0, st>>>(
      a, counts, cnt, static_cast<int*>(v_out), static_cast<int*>(row_out));
  return static_cast<int>(cudaGetLastError());
}
