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
// bound.  The kernel is bound by bytes.  An invalid slot reads its valid
// byte and writes v = -1, ok = false (6 bytes); ragged_expand puts the
// invalid slots in a tail, so whole warps leave early there.  A valid slot
// also reads the fields it needs (j, b_deg and d_start for a delta slot;
// j, b_deg, b_start, t_lo and t_hi for a base slot) and makes one scattered
// 4-byte gather into base or delta, plus, for a base slot whose row has
// tombstones, about log2(run) dependent reads of the tombstone run.  One
// thread owns one slot; slot fields are read coalesced, the gathers go
// through the read-only path, and the tombstone search is the edge_exists
// probe (common.cuh), so an empty run costs no read.
// The wrapper pads absent or zero-length arrays to one slot of -1, as the
// reference does, so m_base, m_delta and m_tomb are at least 1.

#include "common.cuh"

namespace {

__global__ void delta_merge_kernel(
    const int32_t* __restrict__ base, int m_base,
    const int32_t* __restrict__ delta, int m_delta,
    const int32_t* __restrict__ tomb, int m_tomb,
    const int32_t* __restrict__ b_start, const int32_t* __restrict__ b_deg,
    const int32_t* __restrict__ d_start, const int32_t* __restrict__ t_lo,
    const int32_t* __restrict__ t_hi, const int32_t* __restrict__ j,
    const bool* __restrict__ valid, int32_t* __restrict__ v_out,
    bool* __restrict__ ok_out, int k, int n_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  if (!valid[i]) {
    v_out[i] = -1;
    ok_out[i] = false;
    return;
  }
  const int jj = __ldg(j + i);
  const int bd = __ldg(b_deg + i);
  const bool is_base = jj < bd;
  int v;
  bool dead = false;
  if (is_base) {
    v = __ldg(base + repro::clampi(__ldg(b_start + i) + jj, 0, m_base - 1));
    dead = repro::sorted_contains(tomb, m_tomb, __ldg(t_lo + i),
                                  __ldg(t_hi + i), v, n_iters);
  } else {
    v = __ldg(delta + repro::clampi(__ldg(d_start + i) + (jj - bd), 0,
                                    m_delta - 1));
  }
  v_out[i] = v;
  ok_out[i] = !dead;
}

}  // namespace

REPRO_EXPORT int repro_delta_merge(
    const void* base, int m_base, const void* delta, int m_delta,
    const void* tomb, int m_tomb, const void* b_start, const void* b_deg,
    const void* d_start, const void* t_lo, const void* t_hi, const void* j,
    const void* valid, void* v_out, void* ok_out, int k, int n_iters,
    void* stream) {
  constexpr int kThreads = 256;
  delta_merge_kernel<<<repro::blocks_for(k, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(base), m_base,
      static_cast<const int32_t*>(delta), m_delta,
      static_cast<const int32_t*>(tomb), m_tomb,
      static_cast<const int32_t*>(b_start),
      static_cast<const int32_t*>(b_deg),
      static_cast<const int32_t*>(d_start),
      static_cast<const int32_t*>(t_lo), static_cast<const int32_t*>(t_hi),
      static_cast<const int32_t*>(j), static_cast<const bool*>(valid),
      static_cast<int32_t*>(v_out), static_cast<bool*>(ok_out), k, n_iters);
  return static_cast<int>(cudaGetLastError());
}
