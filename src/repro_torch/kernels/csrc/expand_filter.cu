// Fused ragged CSR expansion + bitmap superset filter + order-preserving
// compaction: the executor's per-step hot path.
//
// Replaces the TPU kernel repro/kernels/expand_filter.py
// expand_filter_compact_pallas.  That kernel walks output tiles in a
// sequential grid, fills its own tile range with -1, sorts the tile's
// survivors to its front and appends them at a running base carried across
// grid steps in SMEM.  Hopper's blocks run in parallel and in no order, so
// the running base becomes a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016; the scheme of CUB's DeviceSelect): one launch,
// no memset, each slot evaluated once.
//
// What bounds it on this card: latency, not bytes.  A main-path call moves
// tens of kilobytes (its byte bound is well under a microsecond); its time
// is the launch plus a chain of dependent memory round trips: slot -> row
// search in `offs` -> start[row] -> nbr -> bitmap row, then the blocks'
// prefix.  The design shortens that chain and runs it once:
//
//   * A block takes its logical tile from an atomic ticket, so it only ever
//     waits on tiles whose blocks already run (forward progress).  A tile is
//     128 threads x 1, 2, 4 or 8 slots, thread t holding slots t, t + 128,
//     ...: the launcher takes the most slots per thread that still leave
//     128 blocks, about one per SM, since a small call's gathers go faster
//     spread over more SMs than queued behind fewer (a 16,384-slot call is
//     128 blocks of one slot a thread).
//   * The row search is done once per tile, mostly while the ticket is
//     taken: the block reads `offs` at 128 evenly spaced pivots, which
//     splits the rows of the tile's first and last slot down to 1/128 of
//     them (64 rows for 8192), and 32-way warp rounds narrow wider ranges
//     to 32 rows.  The tile's row window of `offs`, `start` and `deg` is
//     then staged in shared memory and each slot searches only there.  A
//     window wider than kWindow rows (long runs of zero-degree rows) is
//     searched in place in global memory: slower, as correct.
//   * Each slot's (v, row) stays in registers from its test to its write:
//     survivors are ranked in the block by warp ballots and one warp scan of
//     the (slot, warp) counts, so stream order is kept.
//   * Cross-block prefix: each block publishes its survivor count, then its
//     inclusive prefix, as one 64-bit status word (value, flag and the
//     call's epoch together: a reader never sees a value without its flag).
//     A status store follows a fence.acq_rel.gpu (a release) and the
//     look-back's loads precede one (an acquire); the loads and stores are
//     strong (st/ld.relaxed.gpu).  Warp 0 looks back over 32 predecessors per
//     round and stops at the first inclusive prefix.  The last logical tile
//     writes the count, which stays on the device.
//   * The -1 tail: as on the TPU, each block first fills its own slot range
//     of both outputs with -1, and its status is published after a barrier
//     and that fence.  A survivor lands at or below its slot, in its own
//     range or an earlier tile's, and every block writes survivors only
//     after its look-back has acquired (directly, or through an inclusive
//     prefix) the status of every earlier tile, so each survivor write
//     follows the -1 it replaces.  No block has to fill a tail alone.
//   * Scratch is reused and never cleared between calls: the wrapper keeps
//     one status buffer per (device, stream), zeroed by torch.zeros when
//     made, with a status word per tile of the largest call so far and a
//     ticket word last (a larger call gets a new, larger buffer).  Its
//     ticket word carries an epoch that the last logical tile moves on once
//     every ticket of the call is taken, and every status word carries the
//     epoch of the call that wrote it, so words of earlier calls read as
//     not ready and nothing has to reset them (the buffer is zeroed again
//     every 2^30 calls, before the 31-bit epoch could come round).  The
//     epoch lives on the device, so a call replayed from a CUDA graph moves
//     it on too.
//   * Any int32 capacity: a status word's value holds a count up to
//     2^31 - 1, the ticket word's low half any tile count, and slot
//     arithmetic that could pass 2^31 near the top runs in 64 bits.

// The bound id is read on the device (a step's baked scalar or a
// parameterized plan's params[slot]), once per block.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 128;  // fewer slots per thread below this grid
constexpr int kWindow = 2048;   // rows of the tile's window kept in shared
constexpr unsigned kFull = 0xffffffffu;

// The wrapper's persistent scratch, one per (device, stream): at least
// n_tiles status words, then the ticket word, its last word.  The ticket
// word holds the tickets taken by the running call (low kTicketBits) and
// the call's epoch (above).  A status word holds a tile's value (low
// kValueBits), its flag (next 2 bits: 0 none, 1 aggregate, 2 inclusive
// prefix) and the epoch of the call that wrote it (above, 31 bits): a word
// of an earlier call never reads as ready.
struct Scratch {
  unsigned long long* status;
  unsigned long long* ticket;
};
constexpr int kTicketBits = 32;  // holds any int32 tile count
constexpr int kValueBits = 31;   // a count is at most 2^31 - 1
constexpr unsigned long long kAggregate = 1ull << kValueBits;
constexpr unsigned long long kPrefix = 2ull << kValueBits;
constexpr int kEpochShift = kValueBits + 2;

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
  const int32_t* bound;  // *bound < 0: no check
  int capacity;
};

// Strong (relaxed, gpu scope) accesses to the status words: each store
// follows a fence and each load precedes one, which makes them release and
// acquire patterns of the PTX memory model.
// fence.acq_rel.gpu: enough for release and acquire patterns, lighter than
// the sequentially consistent fence of __threadfence
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Narrow the range [lo, hi] that holds the upper bound of k in the sorted
// offs[0, n) (the first index whose entry exceeds k, or n) until it spans
// at most 32 entries.  One warp (every lane must call it): each round
// probes 32 pivots at once and keeps the stride between the last pivot
// <= k and the first > k.  On return, every entry before lo is <= k and
// the entry at hi, if any, exceeds k.
__device__ __forceinline__ void warp_narrow(const int32_t* __restrict__ offs,
                                            int k, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) >> 5;
    const int p = min(lo + (lane + 1) * stride - 1, hi - 1);
    const unsigned gt = __ballot_sync(kFull, __ldg(offs + p) > k);
    if (gt == 0u) {
      lo = hi;
      return;
    }
    const int f = __ffs(gt) - 1;
    hi = min(lo + (f + 1) * stride - 1, hi - 1);
    lo += f * stride;
  }
}

// Each of this thread's slots k0 + i * kThreads + t below n_eff: its row
// (the upper bound of k in offs, searched in the tile's row window
// [u0, u1]), then v = nbr[start[row] + j]; ok marks the valid slots.  The
// window's offs / start / deg come from shared memory (kStaged: rows r_lo
// on) or from global memory.
template <int kItems, bool kStaged>
__device__ __forceinline__ void find_slots(
    const Args& a, const int* s_offs, const int* s_start, const int* s_deg,
    int r_lo, int u0, int u1, int k0, int n_eff, int (&v)[kItems],
    int (&row)[kItems], bool (&ok)[kItems]) {
  auto at = [&](const int* s, const int32_t* g, int r) {
    if constexpr (kStaged) {
      return s[r - r_lo];
    } else {
      return static_cast<int>(__ldg(g + r));
    }
  };
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long kk =
        static_cast<long long>(k0) + i * kThreads + threadIdx.x;
    v[i] = -1;
    row[i] = -1;
    ok[i] = false;
    if (kk >= n_eff) continue;
    const int k = static_cast<int>(kk);
    int lo = u0;
    int hi = u1;
    while (lo < hi) {
      // lo + (hi - lo) / 2: row counts reach 2^31 - 1, where lo + hi wraps
      const int mid = lo + ((hi - lo) >> 1);
      if (at(s_offs, a.offs, mid) <= k) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int r = repro::clampi(lo - 1, 0, a.r_rows - 1);
    const int j = k - at(s_offs, a.offs, r);
    if (j < 0 || j >= at(s_deg, a.deg, r)) continue;
    row[i] = r;
    v[i] = __ldg(a.nbr +
                 repro::clampi(at(s_start, a.start, r) + j, 0, a.m - 1));
    ok[i] = true;
  }
}

template <int kItems>
__global__ void __launch_bounds__(kThreads)
expand_filter_kernel(Args a, Scratch scratch, int n_tiles,
                     int* __restrict__ v_out, int* __restrict__ row_out,
                     int* __restrict__ count_out) {
  constexpr int kTile = kThreads * kItems;
  static_assert(kItems * kWarps <= 32, "one warp scans the block counts");
  __shared__ int s_tile;
  __shared__ unsigned long long s_epoch;  // this call's status epoch bits
  __shared__ int s_bid;
  __shared__ long long s_total;
  __shared__ int s_ub[2];
  __shared__ int s_piv[kThreads];
  __shared__ int s_offs[kWindow];
  __shared__ int s_start[kWindow];
  __shared__ int s_deg[kWindow];
  __shared__ int s_cnt[32];  // survivors per (item, warp), then offsets
  __shared__ int s_base;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // While the ticket is taken: the bound id, the total and offs at
  // kThreads evenly spaced pivots, the first round of every row search
  const int n = a.r_rows;
  const int stride = (n - 1) / kThreads + 1;
  s_piv[t] = __ldg(a.offs + min(static_cast<long long>(t + 1) * stride - 1,
                                static_cast<long long>(n - 1)));
  if (t == 0) {
    const unsigned long long ticket = atomicAdd(scratch.ticket, 1ull);
    const int tile = static_cast<int>(ticket & ((1ull << kTicketBits) - 1));
    const unsigned long long epoch = ticket >> kTicketBits;
    s_tile = tile;
    s_epoch = epoch << kEpochShift;
    // every ticket of this call is taken: the next call starts a new epoch
    if (tile == n_tiles - 1) {
      *scratch.ticket = (epoch + 1) << kTicketBits;
    }
  } else if (t == 32) {
    s_bid = __ldg(a.bound);
  } else if (t == 64) {
    s_total = static_cast<long long>(__ldg(a.offs + n - 1)) +
              __ldg(a.deg + n - 1);
  }
  __syncthreads();
  const int tile = s_tile;
  const int k0 = tile * kTile;
  const int k_end = static_cast<int>(
      min(static_cast<long long>(k0) + kTile,
          static_cast<long long>(a.capacity)));

  // this tile's range of both outputs reads -1 unless a survivor lands there
  for (int i = t; i < k_end - k0; i += kThreads) {
    v_out[k0 + i] = -1;
    row_out[k0 + i] = -1;
  }
  // the ranges that hold the rows of the tile's first and last slot: the
  // pivots' split, then 32-way rounds down to 32 entries
  if (warp < 2) {
    const int k = warp ? k_end - 1 : k0;
    int f = 0;  // pivots <= k
#pragma unroll
    for (int j = 0; j < kThreads / 32; ++j) {
      f += __popc(__ballot_sync(kFull, s_piv[j * 32 + lane] <= k));
    }
    int lo = n;
    int hi = n;
    if (f < kThreads) {
      lo = f * stride;
      hi = static_cast<int>(min(static_cast<long long>(f + 1) * stride - 1,
                                static_cast<long long>(n - 1)));
    }
    warp_narrow(a.offs, k, lo, hi);
    if (lane == 0) s_ub[warp] = warp ? hi : lo;
  }
  __syncthreads();
  // every slot's upper bound lies in [u0, u1]
  const int u0 = s_ub[0];
  const int u1 = s_ub[1];
  const int bid = s_bid;
  const int n_eff = static_cast<int>(min(static_cast<long long>(k_end),
                                         s_total));
  const int r_lo = max(u0 - 1, 0);
  const int n_win = max(u1 - 1, 0) - r_lo + 1;
  const bool staged = n_win <= kWindow;
  if (staged && k0 < n_eff) {
    for (int i = t; i < n_win; i += kThreads) {
      s_offs[i] = __ldg(a.offs + r_lo + i);
      s_start[i] = __ldg(a.start + r_lo + i);
      s_deg[i] = __ldg(a.deg + r_lo + i);
    }
  }
  __syncthreads();

  // each slot once: its row (searched in the window), then v, then the test
  int v[kItems];
  int row[kItems];
  bool ok[kItems];
  if (staged) {
    find_slots<kItems, true>(a, s_offs, s_start, s_deg, r_lo, u0, u1, k0,
                             n_eff, v, row, ok);
  } else {
    find_slots<kItems, false>(a, s_offs, s_start, s_deg, r_lo, u0, u1, k0,
                              n_eff, v, row, ok);
  }
  // the superset test, word-major so each word's kItems gathers are in
  // flight together
  const int32_t* rows[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    rows[i] = a.bitmap +
              static_cast<long long>(repro::clampi(v[i], 0, a.n_vertices - 1)) *
                  a.w;
    ok[i] = ok[i] && (bid < 0 || v[i] == bid);
  }
  for (int kw = 0; kw < a.w; ++kw) {
    const int32_t req = __ldg(a.mask + kw);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (ok[i]) ok[i] = (__ldg(rows[i] + kw) & req) == req;
    }
  }

  // rank in the block: slot order is (item, warp, lane)
  unsigned ballot[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    ballot[i] = __ballot_sync(kFull, ok[i]);
    if (lane == 0) s_cnt[i * kWarps + warp] = __popc(ballot[i]);
  }
  __syncthreads();

  if (warp == 0) {
    const int own = lane < kItems * kWarps ? s_cnt[lane] : 0;
    int x = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane < kItems * kWarps) s_cnt[lane] = x - own;
    const unsigned agg = static_cast<unsigned>(__shfl_sync(kFull, x, 31));
    const unsigned long long epoch = s_epoch;
    unsigned excl = 0;
    // the fence orders the block's -1 fill (before the barrier) before the
    // status word: fence then strong store, a release
    fence_acq_rel();
    if (tile == 0) {
      if (lane == 0) store_relaxed(scratch.status, epoch | kPrefix | agg);
    } else {
      if (lane == 0) {
        store_relaxed(scratch.status + tile, epoch | kAggregate | agg);
      }
      // look back over 32 predecessors per round, nearest in lane 0
      for (int top = tile - 1;; top -= 32) {
        const int idx = top - lane;
        unsigned long long st = kPrefix;  // before tile 0: a prefix of 0
        if (idx >= 0) {
          do {
            st = load_relaxed(scratch.status + idx);
          } while ((st & ~((kPrefix << 1) - 1)) != epoch ||
                   (st & (kAggregate | kPrefix)) == 0);
        }
        const unsigned prefix = __ballot_sync(kFull, (st & kPrefix) != 0);
        const int stop = prefix ? __ffs(prefix) - 1 : 31;
        unsigned add = lane <= stop
                           ? static_cast<unsigned>(st & (kAggregate - 1))
                           : 0u;
        for (int o = 16; o; o >>= 1) add += __shfl_xor_sync(kFull, add, o);
        excl += add;
        if (prefix) break;
      }
      // strong loads then a fence: an acquire of every earlier tile's
      // status (and, through them, of their -1 fills); then a release of
      // this tile's prefix
      fence_acq_rel();
      if (lane == 0) {
        store_relaxed(scratch.status + tile, epoch | kPrefix | (excl + agg));
      }
    }
    if (lane == 0) {
      s_base = static_cast<int>(excl);
      if (tile == n_tiles - 1) *count_out = static_cast<int>(excl + agg);
    }
  }
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (ok[i]) {
      const int dst =
          s_base + s_cnt[i * kWarps + warp] + __popc(ballot[i] & lt);
      v_out[dst] = v[i];
      row_out[dst] = row[i];
    }
  }
}

template <int kItems>
cudaError_t launch(const Args& a, Scratch scratch, int status_words,
                   int* v_out, int* row_out, int* count_out,
                   cudaStream_t st) {
  const int n_tiles = static_cast<int>(
      repro::blocks_for(a.capacity, kThreads * kItems));
  if (n_tiles > status_words) return cudaErrorInvalidValue;
  expand_filter_kernel<kItems><<<n_tiles, kThreads, 0, st>>>(
      a, scratch, n_tiles, v_out, row_out, count_out);
  return cudaGetLastError();
}

}  // namespace

// scratch: scratch_words int64 words kept by the caller for this stream,
// zero at first: a status word per tile (at least ceil(capacity / 1024),
// and 256 for capacities below 2^17, whose tiles are smaller), then the
// ticket word.
REPRO_EXPORT int repro_expand_filter_compact(
    const void* nbr, int m, const void* bitmap, int n_vertices, int w,
    const void* start, const void* deg, const void* offs, int r_rows,
    const void* mask, const void* bound, int capacity,
    void* v_out, void* row_out,
    void* count_out, void* scratch, int scratch_words, void* stream) {
  if (capacity <= 0 || r_rows <= 0 || scratch_words < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(nbr), static_cast<const int32_t*>(bitmap),
         static_cast<const int32_t*>(start), static_cast<const int32_t*>(deg),
         static_cast<const int32_t*>(offs), static_cast<const int32_t*>(mask),
         m, n_vertices, w, r_rows, static_cast<const int32_t*>(bound),
         capacity};
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  const Scratch s{words, words + scratch_words - 1};
  const int n_status = scratch_words - 1;
  int* vo = static_cast<int*>(v_out);
  int* ro = static_cast<int*>(row_out);
  int* co = static_cast<int*>(count_out);
  cudaError_t err;
  if (capacity >= kMinBlocks * kThreads * 8) {
    err = launch<8>(a, s, n_status, vo, ro, co, st);
  } else if (capacity >= kMinBlocks * kThreads * 4) {
    err = launch<4>(a, s, n_status, vo, ro, co, st);
  } else if (capacity >= kMinBlocks * kThreads * 2) {
    err = launch<2>(a, s, n_status, vo, ro, co, st);
  } else {
    err = launch<1>(a, s, n_status, vo, ro, co, st);
  }
  return static_cast<int>(err);
}
