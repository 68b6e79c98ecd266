// Neighborhood-signature prune probe: out[i] = superset(sig[clamp(v[i])], req).
//
// Replaces the TPU kernel repro/kernels/signature_filter.py
// signature_filter_pallas, which kept the whole [V, 2W] table resident in
// VMEM and gathered rows from it.  On Hopper the table stays in device
// memory (it is tens of megabytes at LUBM 1000) and the probe is bound by
// bytes moved in 32-byte sectors: per candidate it reads a 4-byte id,
// gathers one 8W-byte row at a data-dependent place (a whole sector for a
// row of 2 words) and writes one byte.  The gather-and-test body (4 ids a
// thread, 8-byte row words, req in registers, one 32-bit store of 4
// results, one wave of blocks) is superset_probe.cuh's, shared with
// bitmap_superset.cu.

#include "superset_probe.cuh"

// w: int32 words per row.  wide != 0: rows are read as 8-byte words (sig
// 8-byte aligned, w even).  out + head must be 4-byte aligned, head being
// the number of ids before v's first 16-byte boundary.
REPRO_EXPORT int repro_signature_filter(const void* sig, const void* v,
                                        const void* req, void* out, int n,
                                        int n_rows, int w, int wide,
                                        void* stream) {
  if (v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return repro::probe::launch(sig, v, req, out, n, n_rows, w, wide, stream);
}
