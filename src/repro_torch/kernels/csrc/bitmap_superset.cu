// Packed-bitmap superset test: out[i] = (bitmap[i] & req) == req, or, with
// row ids, out[i] = (bitmap[clamp(ids[i])] & req) == req.
//
// Replaces the TPU kernel repro/kernels/bitmap_filter.py
// bitmap_superset_pallas (a VPU pass per row tile over rows gathered
// beforehand).  The engine's label and NLF filters gather a candidate's
// bitmap row and test it, so the ids form takes in that gather: one launch
// instead of a torch index launch that writes B x W words for the kernel to
// read back.  On Hopper both forms are bound by bytes: the ids, the rows
// (distinct 32-byte sectors of the table for the ids form) and one byte out
// per probe.  The body is superset_probe.cuh's, shared with
// signature_filter.cu: 4 ids (or 4 consecutive rows, as 16-byte loads) a
// thread, 8-byte row words where aligned and even, req in registers, one
// 32-bit store of 4 results, one wave of blocks.

#include "superset_probe.cuh"

// bitmap: n_rows rows of w int32 words; ids: n row ids, or nullptr for the
// contract form over rows 0..n-1.  wide != 0: rows are read as 8-byte
// words (bitmap 8-byte aligned, w even).  out + head must be 4-byte
// aligned, head being the number of ids before their first 16-byte
// boundary.
REPRO_EXPORT int repro_bitmap_superset(const void* bitmap, const void* ids,
                                       const void* req, void* out, int n,
                                       int n_rows, int w, int wide,
                                       void* stream) {
  return repro::probe::launch(bitmap, ids, req, out, n, n_rows, w, wide,
                              stream);
}
