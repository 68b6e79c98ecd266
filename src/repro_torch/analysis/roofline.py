"""Roofline cost model of the executor's step kernels.

The port of the binding-table part of ``repro.analysis.roofline``:
first-order traffic / operation models for the executor's step kernels,
keyed by the names ``core.exec._step_kernel_name`` reports:
``expand_filter`` (the fused expand/filter/compact kernel),
``ragged_expand`` (the unfused expand + separate filters + compaction),
``delta_merge`` / ``delta_merge_labeled`` (live-store snapshot merge), and
``edge_exists`` (the per-candidate binary-search join).  The executor's
trace annotations evaluate them per step, so a measured wall time sits
next to a roofline estimate in every ``step`` span.  The formulas are the
reference's; only the peaks differ.

Units: int32/float32 elements (4 B).  ``expanded`` = ragged expansion
total for the step, ``rows`` = input binding-table rows, ``capacity`` =
the step's capacity (table writes are capacity-shaped, not row-shaped),
``nq`` = binding-table width, ``bitmap_words`` = label-bitmap words per
vertex, ``n_iters`` = binary-search iterations (about log2(max degree)).
"""

from __future__ import annotations

# (peak op/s, memory B/s) per ``torch.device.type``.  ``cuda`` holds one
# H100 SXM's data-sheet peaks (HBM3 at 3.35 TB/s; 67 T float32 op/s outside
# the tensor cores, the rate the kernels' 32-bit integer work runs at), the
# peaks ``chip_smoke.py`` bounds every kernel with; ``cpu`` is the
# reference's order-of-magnitude single-device row.
BACKEND_PEAKS = {
    "cuda": (67e12, 3.35e12),
    "cpu": (2.0e11, 4.0e10),
}

KERNEL_MODELS = ("expand_filter", "ragged_expand", "delta_merge",
                 "delta_merge_labeled", "edge_exists")


def kernel_cost(kernel: str, *, expanded: float, rows: float = 0.0,
                capacity: float = 0.0, nq: int = 4, bitmap_words: int = 1,
                n_iters: int = 20) -> dict:
    """Cost tuple ({flops, bytes, coll}) for one executor step kernel, as
    the reference computes it."""
    expanded = max(0.0, float(expanded))
    rows = max(0.0, float(rows))
    capacity = max(0.0, float(capacity))
    w = max(1, int(bitmap_words))
    it = max(1, int(n_iters))
    table = capacity * (nq + 1) * 4.0  # one table image (B + pvar/org cols)
    if kernel == "expand_filter":
        # CSR degree/start reads, one neighbor gather + bitmap gather per
        # expansion, in-kernel prefix sum, one gather-built output table
        bytes_ = rows * 12.0 + expanded * (8.0 + 4.0 * w) + 2.0 * table
        flops = expanded * (2.0 + w) + 2.0 * capacity
    elif kernel == "ragged_expand":
        # unfused: expansion triple (row, j, valid) materialized, filters
        # re-read candidates, scatter-compact touches the padded table twice
        bytes_ = rows * 12.0 + expanded * (16.0 + 4.0 * w) + 3.0 * table
        flops = expanded * (4.0 + w) + 3.0 * capacity
    elif kernel in ("delta_merge", "delta_merge_labeled"):
        # base + delta CSR reads and a tombstone binary search per
        # expansion on top of the unfused path; the labeled variant also
        # reads/writes the edge-label column
        lab = 8.0 if kernel == "delta_merge_labeled" else 0.0
        bytes_ = (rows * 24.0 + expanded * (16.0 + lab + 4.0 * (w + it))
                  + 3.0 * table)
        flops = expanded * (6.0 + w + it) + 3.0 * capacity
    elif kernel == "edge_exists":
        # per-candidate binary search over the probe vertex's adjacency
        bytes_ = expanded * 4.0 * it
        flops = expanded * float(it)
    else:
        raise ValueError(f"unknown kernel {kernel!r}; "
                         f"known: {KERNEL_MODELS}")
    return {"flops": flops, "bytes": bytes_, "coll": {}}


def estimate_step_ms(kernel: str, backend: str = "cpu", **kw) -> dict:
    """Roofline time estimate for one executor step on one device of type
    ``backend`` (a ``torch.device.type`` key of :data:`BACKEND_PEAKS`).
    Returns ``{model_ms, dominant, flops, bytes}`` — what the executor
    attaches to its ``step`` trace spans."""
    cost = kernel_cost(kernel, **kw)
    peak_f, bw = BACKEND_PEAKS[backend]
    compute_s = cost["flops"] / peak_f
    memory_s = cost["bytes"] / bw
    return {"model_ms": max(compute_s, memory_s) * 1e3,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "flops": cost["flops"], "bytes": cost["bytes"]}
