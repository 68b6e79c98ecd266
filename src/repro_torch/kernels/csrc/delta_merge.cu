// Live-store slot resolution: for each slot of a merged adjacency list
// (base CSR slice ++ delta slice), read the candidate from the base or the
// delta array and mask base candidates found in the row's sorted tombstone
// slice.  v[i] = -1 where !valid[i]; ok[i] = valid[i] && !dead.
//
// Replaces the TPU kernel repro/kernels/delta_merge.py delta_merge_pallas,
// which staged the base, delta and tombstone arrays whole in VMEM and so
// fell back to its jnp oracle once they passed 2^20 words together: at the
// scale users hold (a base adjacency of millions of words) the TPU never
// ran it.  Here the three arrays stay in device memory and have no size
// bound.
//
// Two forms.  Without row ids (the TPU contract) the five fields b_start,
// b_deg, d_start, t_lo and t_hi are per-slot arrays.  With row ids (the
// engine's merged step) they are row-level arrays and slot i reads
// field[clamp(row[i])]: the step no longer gathers five per-slot copies
// (five launches that write 20 bytes a slot for this kernel to read back).
// d_start, t_lo and t_hi may be null and then read as 0.
//
// The kernel is bound by bytes: per slot the valid byte, and for a valid
// slot j, its row (or its fields), one scattered 4-byte gather into base
// or delta, and for a base slot whose row has tombstones about log2(run)
// dependent reads of the tombstone run; v and ok out.  The design:
//
//   * 4 slots a thread: row (or each per-slot field), j and valid as 16-,
//     16- and 4-byte loads, v and ok stored as one 16-byte and one 32-bit
//     word; where k % 4 != 0 or an input is not aligned, the slots outside
//     the groups run one a thread;
//   * a group of 4 invalid slots stores -1 / false and leaves, so whole
//     warps leave early in the invalid tail that ragged_expand leaves;
//   * the row-level fields go through the read-only path; neighbouring
//     slots mostly share a row, so they hit L1 or L2.  A valid slot loads
//     all five fields in one round (not b_deg first, then the ones its kind
//     needs): one dependent round trip fewer for a few cached bytes;
//   * all 4 base / delta gathers of a thread are issued before any
//     tombstone search, and its 4 searches run interleaved, one probe of
//     each per round, so 4 dependent chains are in flight per thread.
//
// The wrapper pads absent or zero-length adjacency arrays to one slot of
// -1, as the reference does, so m_base, m_delta and m_tomb are at least 1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const int32_t* base;
  int m_base;
  const int32_t* delta;
  int m_delta;
  const int32_t* tomb;
  int m_tomb;
  const int32_t* b_start;
  const int32_t* b_deg;
  const int32_t* d_start;  // may be null: 0
  const int32_t* t_lo;     // may be null: 0
  const int32_t* t_hi;     // may be null: 0
  const int32_t* row;      // null: the fields are per slot
  int n_fields;            // rows of the row-level fields
  const int32_t* j;
  const bool* valid;
  int32_t* v_out;
  bool* ok_out;
  int k;
  int n_iters;
  int n_vec;  // groups of 4 slots read with vector loads
};

// The five fields of kN slots, then their candidates and tombstone tests.
template <int kN>
struct Slots {
  bool live[kN];
  int jj[kN], bd[kN], bs[kN], ds[kN], lo[kN], hi[kN];
  int v[kN];
  bool ok[kN];
};

__device__ __forceinline__ int field_at(const int32_t* __restrict__ f,
                                        int idx) {
  return f != nullptr ? __ldg(f + idx) : 0;
}

// Loads the fields of live slots whose field index is f[s].
template <int kN>
__device__ __forceinline__ void gather_fields(const Args& a, const int (&f)[kN],
                                              Slots<kN>& s) {
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    s.bd[q] = s.bs[q] = s.ds[q] = s.lo[q] = s.hi[q] = 0;
    if (s.live[q]) {
      s.bd[q] = __ldg(a.b_deg + f[q]);
      s.bs[q] = __ldg(a.b_start + f[q]);
      s.ds[q] = field_at(a.d_start, f[q]);
      s.lo[q] = field_at(a.t_lo, f[q]);
      s.hi[q] = field_at(a.t_hi, f[q]);
    }
  }
}

// Candidates, then the interleaved tombstone searches: slot q is dead when
// its base candidate lies in tomb[lo, hi).  Each search is
// common.cuh's sorted_contains (at most n_iters halving rounds, stopping
// once its range is empty), run in lockstep with the others.
template <int kN>
__device__ __forceinline__ void resolve(const Args& a, Slots<kN>& s) {
  int l[kN], h[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const bool base = s.jj[q] < s.bd[q];
    s.v[q] = -1;
    if (s.live[q]) {
      s.v[q] = base ? __ldg(a.base + repro::clampi(s.bs[q] + s.jj[q], 0,
                                                   a.m_base - 1))
                    : __ldg(a.delta + repro::clampi(
                                          s.ds[q] + (s.jj[q] - s.bd[q]), 0,
                                          a.m_delta - 1));
    }
    if (!(s.live[q] && base)) s.lo[q] = s.hi[q] = 0;  // nothing to search
    l[q] = s.lo[q];
    h[q] = s.hi[q];
  }
  for (int it = 0; it < a.n_iters; ++it) {
    bool more = false;
#pragma unroll
    for (int q = 0; q < kN; ++q) more |= l[q] < h[q];
    if (!more) break;
    int t[kN];
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      t[q] = l[q] < h[q]
                 ? __ldg(a.tomb + repro::clampi(l[q] + ((h[q] - l[q]) >> 1), 0,
                                                a.m_tomb - 1))
                 : 0;
    }
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      if (l[q] < h[q]) {
        // l + (h - l) / 2: a tombstone run may lie past offset 2^30
        const int mid = l[q] + ((h[q] - l[q]) >> 1);
        if (t[q] < s.v[q]) {
          l[q] = mid + 1;
        } else {
          h[q] = mid;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const bool dead = s.lo[q] < s.hi[q] && l[q] < s.hi[q] &&
                      __ldg(a.tomb + repro::clampi(l[q], 0, a.m_tomb - 1)) ==
                          s.v[q];
    s.ok[q] = s.live[q] && !dead;
  }
}

__device__ __forceinline__ void to4(int4 x, int (&o)[4]) {
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ int4 load4(const int32_t* __restrict__ f, int g) {
  return f != nullptr ? __ldg(reinterpret_cast<const int4*>(f) + g)
                      : make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads)
delta_merge_kernel(const Args a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < a.n_vec) {
    int4* v4 = reinterpret_cast<int4*>(a.v_out) + t;
    uint32_t* ok4 = reinterpret_cast<uint32_t*>(a.ok_out) + t;
    const uint32_t live4 =
        __ldg(reinterpret_cast<const uint32_t*>(a.valid) + t);
    if (live4 == 0) {
      *v4 = make_int4(-1, -1, -1, -1);
      *ok4 = 0;
      return;
    }
    Slots<4> s;
#pragma unroll
    for (int q = 0; q < 4; ++q) s.live[q] = ((live4 >> (8 * q)) & 0xff) != 0;
    to4(__ldg(reinterpret_cast<const int4*>(a.j) + t), s.jj);
    if (a.row != nullptr) {
      int f[4];
      to4(__ldg(reinterpret_cast<const int4*>(a.row) + t), f);
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = repro::clampi(f[q], 0, a.n_fields - 1);
      gather_fields(a, f, s);
    } else {
      to4(load4(a.b_deg, t), s.bd);
      to4(load4(a.b_start, t), s.bs);
      to4(load4(a.d_start, t), s.ds);
      to4(load4(a.t_lo, t), s.lo);
      to4(load4(a.t_hi, t), s.hi);
    }
    resolve(a, s);
    *v4 = make_int4(s.v[0], s.v[1], s.v[2], s.v[3]);
    *ok4 = static_cast<uint32_t>(s.ok[0]) |
           (static_cast<uint32_t>(s.ok[1]) << 8) |
           (static_cast<uint32_t>(s.ok[2]) << 16) |
           (static_cast<uint32_t>(s.ok[3]) << 24);
    return;
  }
  // the slots outside the groups, one a thread
  const int i = 4 * a.n_vec + (t - a.n_vec);
  if (i >= a.k) return;
  Slots<1> s;
  s.live[0] = a.valid[i];
  if (!s.live[0]) {
    a.v_out[i] = -1;
    a.ok_out[i] = false;
    return;
  }
  s.jj[0] = __ldg(a.j + i);
  const int f[1] = {a.row != nullptr
                        ? repro::clampi(__ldg(a.row + i), 0, a.n_fields - 1)
                        : i};
  gather_fields(a, f, s);
  resolve(a, s);
  a.v_out[i] = s.v[0];
  a.ok_out[i] = s.ok[0];
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// row == nullptr: b_start .. t_hi are per-slot arrays of k words; else they
// are n_fields row-level words each and row holds k row ids.  d_start, t_lo
// and t_hi may be null.
REPRO_EXPORT int repro_delta_merge(
    const void* base, int m_base, const void* delta, int m_delta,
    const void* tomb, int m_tomb, const void* b_start, const void* b_deg,
    const void* d_start, const void* t_lo, const void* t_hi, const void* row,
    int n_fields, const void* j, const void* valid, void* v_out, void* ok_out,
    int k, int n_iters, void* stream) {
  if (k <= 0 || m_base < 1 || m_delta < 1 || m_tomb < 1 || !b_start ||
      !b_deg || (row && n_fields < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const int32_t*>(base),    m_base,
         static_cast<const int32_t*>(delta),   m_delta,
         static_cast<const int32_t*>(tomb),    m_tomb,
         static_cast<const int32_t*>(b_start), static_cast<const int32_t*>(b_deg),
         static_cast<const int32_t*>(d_start), static_cast<const int32_t*>(t_lo),
         static_cast<const int32_t*>(t_hi),    static_cast<const int32_t*>(row),
         n_fields,                             static_cast<const int32_t*>(j),
         static_cast<const bool*>(valid),      static_cast<int32_t*>(v_out),
         static_cast<bool*>(ok_out),           k,
         n_iters,                              0};
  // vector groups when every per-slot stream is aligned for them
  bool vec = aligned(j, 16) && aligned(valid, 4) && aligned(v_out, 16) &&
             aligned(ok_out, 4);
  const void* per_slot[5] = {row ? row : b_start, row ? nullptr : b_deg,
                             row ? nullptr : d_start, row ? nullptr : t_lo,
                             row ? nullptr : t_hi};
  for (const void* p : per_slot) vec = vec && aligned(p, 16);
  a.n_vec = vec ? k / 4 : 0;
  const long long threads = a.n_vec + (k - 4LL * a.n_vec);
  delta_merge_kernel<<<repro::blocks_for(threads, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
