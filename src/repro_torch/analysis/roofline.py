"""Roofline analysis of the dry run's records, and the cost model of the
executor's step kernels.

**Analyzer** (``analyze`` / ``main``): three terms a (arch × cell) on the
single-pod mesh (256 ranks), with one H100 SXM's data-sheet peaks:

    compute_s    = flops_per_rank / 989e12     (bf16 dense tensor cores)
    memory_s     = bytes_per_rank / 3.35e12    (HBM3)
    collective_s = Σ_op factor(op) · collective_bytes_per_rank / 450e9
        (NVLink 4, one direction; factors: all-reduce 2, the rest 1)

The costs come from ``launch.dryrun``'s traces, whose LM records already
span every layer (the eager trace counts each layer it runs, and the
dry run extrapolates two small depths), so ``corrected_cost`` takes a
record's cost as it is.
MODEL_FLOPS comes from ``analysis.model_flops``; ratio = MODEL_FLOPS /
(flops_per_rank × ranks).

**Kernel models**: the port of the binding-table part of
``repro.analysis.roofline``:
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

import argparse
import json
from pathlib import Path

# one H100 SXM's data-sheet peaks (NVIDIA H100 Tensor Core GPU datasheet):
# bf16 dense tensor-core rate, HBM3 bandwidth, NVLink 4 bandwidth a
# direction
H100_SXM_BF16_FLOPS = 989e12
H100_SXM_HBM_BW = 3.35e12
H100_SXM_NVLINK_BW = 450e9
PEAK_FLOPS = H100_SXM_BF16_FLOPS
HBM_BW = H100_SXM_HBM_BW
LINK_BW = H100_SXM_NVLINK_BW
CHIPS_SINGLE = 256
COLL_FACTORS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

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
# the port's own: the label filter's ids form, which the dry run charges
PORT_MODELS = ("bitmap_superset",)


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
    elif kernel == "bitmap_superset":
        # ids form: an id, its vertex's bitmap words and a flag a candidate
        bytes_ = expanded * (4.0 + 4.0 * w + 1.0)
        flops = expanded * 2.0 * w
    else:
        raise ValueError(f"unknown kernel {kernel!r}; "
                         f"known: {KERNEL_MODELS + PORT_MODELS}")
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


def op_call_cost(op: str, args: tuple) -> tuple[str, dict]:
    """The kernel and the cost tuple of one call of a hand-written kernel's
    operator ``repro_torch::<op>`` (:mod:`repro_torch.kernels.ops`) on
    ``args``, its schema's arguments in order: what the dry run charges
    for the call."""
    if op == "edge_exists":
        lo, n_iters = args[1], args[4]
        return op, kernel_cost("edge_exists", expanded=lo.shape[0],
                               n_iters=n_iters)
    if op in ("bitmap_superset", "signature_filter"):
        table, ids = args[0], args[2] if op == "bitmap_superset" else args[1]
        n = table.shape[0] if ids is None else ids.shape[0]
        return op, kernel_cost("bitmap_superset", expanded=n,
                               bitmap_words=table.shape[1])
    if op == "expand_filter_compact":
        bitmap, offs, capacity = args[1], args[4], args[7]
        return op, kernel_cost("expand_filter", expanded=capacity,
                               rows=offs.shape[0], capacity=capacity,
                               bitmap_words=bitmap.shape[1])
    if op == "delta_merge":
        j, n_iters = args[8], args[10]
        return op, kernel_cost("delta_merge", expanded=j.shape[0],
                               n_iters=n_iters)
    if op in ("tile_membership", "tile_membership_range"):
        a, b = args[0], args[1]
        r, ta, tb = ((a.shape[0], a.shape[1], b.shape[1])
                     if op == "tile_membership" else (a.shape[0], 1, args[4]))
        return "tile_membership", {"flops": float(r * ta * tb),
                                   "bytes": float(r * (ta + tb) * 4 + r * ta),
                                   "coll": {}}
    if op in ("segment_gather_fixed", "segment_gather_sum"):
        # ids, the rows they read, the sums written
        table, idx = args[0], args[1]
        e, s = ((idx.numel(), idx.shape[0]) if op == "segment_gather_fixed"
                else (idx.shape[0], args[3]))
        d, elt = table.shape[1], table.element_size()
        return "segment_gather", {
            "flops": 2.0 * e * d,
            "bytes": float(e * 4 + e * d * elt + s * d * elt), "coll": {}}
    raise ValueError(f"no cost model for kernel operator {op!r}")


# --------------------------------------------------------------------------
# analyzer over the dry run's records
# --------------------------------------------------------------------------


def _cost_tuple(rec: dict) -> dict:
    coll = rec.get("collective_bytes", {})
    return {
        "flops": rec.get("flops", 0.0),
        "bytes": rec.get("bytes_accessed", 0.0),
        "coll": {k: v for k, v in coll.items() if k != "total"},
    }


def _combine(fixed, per, n):
    out = {"flops": fixed["flops"] + n * per["flops"],
           "bytes": fixed["bytes"] + n * per["bytes"],
           "coll": {}}
    keys = set(fixed["coll"]) | set(per["coll"])
    for k in keys:
        out["coll"][k] = fixed["coll"].get(k, 0) + n * per["coll"].get(k, 0)
    return out


def _sub(a, b):
    return {"flops": a["flops"] - b["flops"], "bytes": a["bytes"] - b["bytes"],
            "coll": {k: a["coll"].get(k, 0) - b["coll"].get(k, 0)
                     for k in set(a["coll"]) | set(b["coll"])}}


def corrected_cost(arch_name: str, cell: str, dryrun_rec: dict,
                   cache_dir: Path | None = None) -> dict:
    """Per-rank cost over every layer.  The reference corrects XLA's
    count of a scanned layer stack by depth differencing here; the port's
    dry-run records already span every layer (their ``depth`` is
    ``"full"`` or ``"extrapolated"``: ``launch.dryrun.trace_cell``), so
    the record's cost is the corrected one.  ``arch_name``, ``cell`` and
    ``cache_dir`` are the reference's arguments."""
    if dryrun_rec.get("depth") not in ("full", "extrapolated"):
        raise ValueError(f"{arch_name}/{cell}: a dry-run record without its "
                         f"depth ({dryrun_rec.get('depth')!r}); trace it "
                         f"again with launch.dryrun")
    return _cost_tuple(dryrun_rec)


def roofline_terms(cost: dict, chips: int = CHIPS_SINGLE,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict:
    """The three terms of a per-rank cost (``chips`` is the reference's
    argument, unused by the per-rank terms)."""
    compute_s = cost["flops"] / peak_flops
    memory_s = cost["bytes"] / hbm_bw
    coll_s = sum(COLL_FACTORS.get(k, 1.0) * v
                 for k, v in cost["coll"].items()) / link_bw
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", coll_s)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant}


def analyze(dryrun_dir: Path, out_dir: Path, archs=None) -> list[dict]:
    from repro_torch.analysis.model_flops import model_flops
    from repro_torch.configs import all_archs, get_arch

    rows = []
    for arch_name in (archs or all_archs()):
        arch = get_arch(arch_name)
        for cell in sorted(arch.cells):
            rec_path = dryrun_dir / "single" / f"{arch_name}--{cell}.json"
            if not rec_path.exists():
                continue
            rec = json.loads(rec_path.read_text())
            if rec.get("status") != "ok":
                continue
            cost = corrected_cost(arch_name, cell, rec)
            terms = roofline_terms(cost)
            row = {"arch": arch_name, "cell": cell, **terms,
                   "hlo_flops_per_chip": cost["flops"],
                   "hlo_bytes_per_chip": cost["bytes"],
                   "coll_bytes_per_chip": sum(cost["coll"].values()),
                   "raw_flops_per_chip": rec.get("flops", 0.0)}
            if arch.family != "engine":
                mf = model_flops(arch_name, cell)
                row["model_flops"] = mf
                denom = cost["flops"] * CHIPS_SINGLE
                row["useful_ratio"] = mf / denom if denom else 0.0
                step_s = max(terms["compute_s"], terms["memory_s"],
                             terms["collective_s"])
                row["roofline_frac"] = (
                    mf / CHIPS_SINGLE / PEAK_FLOPS) / step_s if step_s else 0.0
            rows.append(row)
            print(f"[roofline] {arch_name:18s} {cell:14s} "
                  f"c={terms['compute_s']:.2e}s m={terms['memory_s']:.2e}s "
                  f"n={terms['collective_s']:.2e}s dom={terms['dominant']:10s}"
                  f" ratio={row.get('useful_ratio', float('nan')):.3f}",
                  flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "roofline.json").write_text(json.dumps(rows, indent=1))
    (out_dir / "roofline.md").write_text(to_markdown(rows))
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | cell | compute_s | memory_s | collective_s | dominant | "
           "MODEL_FLOPS | useful ratio | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    body = "".join(
        f"| {r['arch']} | {r['cell']} | {r['compute_s']:.3e} | "
        f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
        f"{r.get('model_flops', 0):.3e} | {r.get('useful_ratio', 0):.3f} | "
        f"{r.get('roofline_frac', 0):.3f} |\n"
        for r in rows)
    return hdr + body


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="runs/dryrun")
    ap.add_argument("--out", default="runs/roofline")
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    analyze(Path(args.dryrun), Path(args.out),
            archs=[args.arch] if args.arch else None)


if __name__ == "__main__":
    main()
