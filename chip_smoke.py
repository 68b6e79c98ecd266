#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--scale N]

Phases, each fatal on failure (no phase's error is caught):

1. print the card's name and power limit (``nvidia-smi``);
2. build the five Hopper kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on small CUDA inputs;
4. parity scale: LUBM (scale 8, density 0.6) and BSBM (3000 products)
   through ``SparqlEngine.query`` on the card; the counts must equal
   ``benchmarks/BENCH_exec.json``;
5. full scale: LUBM at ``--scale`` universities (default 1000, about 7.6M
   triples), all 14 LUBM queries in bindings and in count mode, cold and
   warm latency, peak device memory; every count and every binding row is
   held against the port's CPU run of the same query;
6. each kernel's wrapper on the largest inputs the main path gave it
   (phases 4-5), held bit-equal against its plain version and timed beside
   it with CUDA events, with its byte bound.

The kernels' launch counters are reset just before phase 4 and read just
after phase 5; a kernel of the path launched no time fails the run.  The
last lines are the ``kernels`` JSON object, then the device line.  Details
go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet):
# HBM bytes/s, and the float32 non-tensor rate used for the kernels' few
# 32-bit integer operations per byte
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

KERNEL_INFO = {
    "expand_filter_compact": ("src/repro_torch/kernels/csrc/expand_filter.cu",
                              "src/repro/kernels/expand_filter.py:113"),
    "edge_exists": ("src/repro_torch/kernels/csrc/edge_exists.cu",
                    "src/repro/kernels/edge_exists.py:46"),
    "tile_membership": ("src/repro_torch/kernels/csrc/tile_membership.cu",
                        "src/repro/kernels/sorted_intersect.py:34"),
    "bitmap_superset": ("src/repro_torch/kernels/csrc/bitmap_superset.cu",
                        "src/repro/kernels/bitmap_filter.py:27"),
    "signature_filter": ("src/repro_torch/kernels/csrc/signature_filter.cu",
                         "src/repro/kernels/signature_filter.py:35"),
}
PARITY = {  # BENCH_exec.json keys checked at parity scale
    "lubm": ("Q2", "Q8", "Q9", "Q13"),
    "bsbm": ("B1", "B3", "B5", "B8"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# --------------------------------------------------------------- recording


class Recorder:
    """Wraps the kernel entry points of ``repro_torch.kernels.ops`` and keeps
    the arguments of the largest call of each kernel, so phase 6
    can rerun it at the main path's own shapes.  The wrapped call is the
    original wrapper, so launch counts are unchanged."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: dict[str, tuple] = {}
        self.orig = {name: getattr(ops, name) for name in ops.KERNELS}

    @staticmethod
    def rows(name, args) -> tuple[int, ...]:
        """A call's size: its input rows (then, for the fused step, its
        capacity), read from shapes only so recording adds no sync."""
        if name == "expand_filter_compact":
            return (int(args[4].shape[0]), int(args[7]))  # offs rows, cap
        if name in ("signature_filter", "edge_exists"):
            return (int(args[1].shape[0]),)
        return (int(args[0].shape[0]),)  # tile_membership, bitmap_superset

    def install(self) -> None:
        for name, fn in self.orig.items():
            def wrapped(*args, _name=name, _fn=fn, **kw):
                if args[0].is_cuda:
                    r = self.rows(_name, args)
                    best = self.calls.get(_name)
                    if best is None or r > best[0]:
                        self.calls[_name] = (r, args, kw)
                return _fn(*args, **kw)
            setattr(self.ops, name, wrapped)

    def remove(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


# ------------------------------------------------------------------ timing


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each; the 50 MB L2 is flushed before each run, as the main path finds
    its inputs after other steps' traffic."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def bound(torch, ref, name, args, kw) -> tuple[float, float, str]:
    """(bytes, ops, bound_by) the call must at least move / do on these
    inputs: each input read once and each output written once, counting
    only the rows and words this data touches."""
    def nb(t):
        return t.numel() * t.element_size()

    if name == "bitmap_superset":
        bm, req = args
        byts = nb(bm) + nb(req) + bm.shape[0]
        ops = 2 * bm.numel()
    elif name == "signature_filter":
        sig, v, req = args
        uniq = torch.unique(v.clamp(0, sig.shape[0] - 1)).numel()
        byts = nb(v) + uniq * sig.shape[1] * 4 + nb(req) + v.shape[0]
        ops = 2 * v.shape[0] * sig.shape[1]
    elif name == "tile_membership":
        a, b = args
        byts = nb(a) + nb(b) + a.numel()
        ops = 2 * a.numel() * b.shape[1]
    elif name == "edge_exists":
        nbr, lo, hi, tgt = args
        ln = (hi - lo).clamp(min=0).double()
        words = torch.ceil(torch.log2(ln + 1)).sum().item()
        words = min(words, float(nbr.numel()))
        byts = nb(lo) + nb(hi) + nb(tgt) + 4 * words + lo.shape[0]
        ops = 3 * words
    else:  # expand_filter_compact
        nbr, bitmap, start, deg, offs, mask = args[:6]
        cap = int(args[7])
        row, j, valid = ref.ragged_expand_ref(offs, deg, cap)
        pos = (start[row] + j)[valid]
        v = nbr[pos.clamp(0, nbr.shape[0] - 1)]
        n_valid = int(valid.sum().item())
        byts = (nb(start) + nb(deg) + nb(offs) + nb(mask)
                + 4 * torch.unique(pos).numel()
                + bitmap.shape[1] * 4 * torch.unique(v).numel()
                + 2 * 4 * cap + 4)
        ops = cap * (max(1, offs.shape[0]).bit_length() + 4) \
            + 2 * n_valid * bitmap.shape[1]
    by = "bytes" if byts / PEAK_BYTES_S >= ops / PEAK_OPS_S else "operations"
    return float(byts), float(ops), by


def max_abs_err(torch, got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g_, w_ in zip(got, want):
        check(g_.shape == w_.shape and g_.dtype == w_.dtype,
              f"shape/dtype {tuple(g_.shape)} {g_.dtype} vs "
              f"{tuple(w_.shape)} {w_.dtype}")
        d = (g_.long() - w_.long()).abs()
        err = max(err, float(d.max().item()) if d.numel() else 0.0)
    return err


# ------------------------------------------------------------------ phases


def synthetic_checks(torch, ops, ref) -> None:
    """Phase 3: each kernel against its plain version on small inputs."""
    import numpy as np

    rng = np.random.default_rng(0)
    dev = "cuda"

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(dev)

    nbr = np.sort(rng.integers(0, 5000, 20000)).astype(np.int32)
    lo = rng.integers(0, 20000, 5000).astype(np.int32)
    hi = np.minimum(20000, lo + rng.integers(0, 40, 5000)).astype(np.int32)
    tgt = np.where(rng.random(5000) < 0.5, nbr[lo], rng.integers(0, 5000, 5000)).astype(np.int32)
    a = (t(nbr), t(lo), t(hi), t(tgt))
    cases = [("edge_exists", lambda: ops.edge_exists(*a, n_iters=8),
              lambda: ref.edge_exists_ref(*a, n_iters=8))]
    ta = t(rng.integers(-1, 50, (3000, 1)).astype(np.int32))
    tb = t(rng.integers(-2, 50, (3000, 64)).astype(np.int32))
    cases.append(("tile_membership", lambda: ops.tile_membership(ta, tb),
                  lambda: ref.tile_membership_ref(ta, tb)))
    for w in (1, 2, 5):
        bm = t(rng.integers(0, 2**32, (4000, w), dtype=np.uint64).astype(np.uint32))
        req = t(np.full(w, 0x80000003, np.uint32))
        cases.append((f"bitmap_superset w={w}",
                      lambda bm=bm, req=req: ops.bitmap_superset(bm, req),
                      lambda bm=bm, req=req: ref.bitmap_superset_ref(bm, req)))
        sig = t(rng.integers(0, 2**32, (3000, 2 * w), dtype=np.uint64).astype(np.uint32))
        vv = t(rng.integers(-2, 3003, 4000).astype(np.int32))
        sreq = t(np.full(2 * w, 0x00010001, np.uint32))
        cases.append((f"signature_filter w={2 * w}",
                      lambda sig=sig, vv=vv, sreq=sreq: ops.signature_filter(sig, vv, sreq),
                      lambda sig=sig, vv=vv, sreq=sreq: ref.signature_filter_ref(sig, vv, sreq)))
        deg = rng.integers(0, 9, 5000).astype(np.int32)
        deg[::4] = 0
        m = int(deg.sum()) + 3
        enbr = t(rng.integers(0, 3000, m).astype(np.int32))
        start = t((np.cumsum(deg) - deg).astype(np.int32))
        offs = start.clone()
        emask = t(np.array([5] + [0] * (w - 1), np.uint32))
        ebm = t(rng.integers(0, 2**32, (3000, w), dtype=np.uint64).astype(np.uint32))
        tdeg = t(deg)
        for cap, bid in ((1 << 15, -1), (1 << 12, -1), (1 << 15, 7)):
            args = (enbr, ebm, start, tdeg, offs, emask, bid, cap)
            cases.append((f"expand_filter_compact w={w} cap={cap} bid={bid}",
                          lambda args=args: ops.expand_filter_compact(*args),
                          lambda args=args: ref.expand_filter_compact_ref(*args)))
    for label, kern, plain in cases:
        got = kern()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, plain())
        check(err == 0, f"{label}: kernel differs from its plain version")
    log(f"phase 3: {len(cases)} kernel checks bit-equal to the plain versions")


def run_parity(torch, bench: dict) -> dict:
    """Phase 4: BENCH_exec.json counts on the card."""
    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_bsbm, generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import BSBM_QUERIES, LUBM_QUERIES

    out = {}
    for ds, make, queries in (
            ("lubm", lambda: generate_lubm(scale=8, seed=0, density=0.6),
             LUBM_QUERIES),
            ("bsbm", lambda: generate_bsbm(n_products=3000, seed=1),
             BSBM_QUERIES)):
        g, maps = type_aware_transform(make().finalize())
        eng = SparqlEngine(g, maps)
        for name in PARITY[ds]:
            want = bench[f"{ds}.{name}"]["count"]
            got = eng.query(queries[name]).count
            got_c = eng.count(queries[name])
            check(got == want == got_c,
                  f"{ds}.{name}: count {got} (count mode {got_c}), "
                  f"BENCH_exec.json {want}")
            out[f"{ds}.{name}"] = got
    log(f"phase 4: parity counts equal BENCH_exec.json: {out}")
    return out


def run_full(torch, ops, scale: int) -> dict:
    """Phase 5: all LUBM queries at full scale on the card, held against
    the port's CPU run."""
    import numpy as np

    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES

    t0 = time.perf_counter()
    st = generate_lubm(scale=scale, seed=0, density=1.0).finalize()
    t1 = time.perf_counter()
    g, maps = type_aware_transform(st)
    t2 = time.perf_counter()
    info = {"scale": scale, "triples": int(st.s.shape[0]),
            "vertices": int(g.n_vertices), "edges": int(g.n_edges),
            "generate_s": t1 - t0, "transform_s": t2 - t1}
    log(f"phase 5: LUBM scale {scale}: {info}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    eng = SparqlEngine(g, maps)
    torch.cuda.synchronize()
    info["engine_build_s"] = time.perf_counter() - t3

    def timed(fn):
        s = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - s) * 1e3

    queries = {}
    gpu_rows = {}
    for name, q in LUBM_QUERIES.items():
        res, cold = timed(lambda: eng.query(q))
        before = dict(ops.launches)
        warm = []
        for _ in range(3):
            r2, ms = timed(lambda: eng.query(q))
            warm.append(ms)
            check(r2.count == res.count and np.array_equal(r2.rows, res.rows),
                  f"{name}: warm run differs from cold run")
        per_query = {k: (ops.launches[k] - before[k]) // 3 for k in before}
        cres, count_cold = timed(lambda: eng.query(q, collect="count"))
        count_warm = []
        for _ in range(3):
            c2, ms = timed(lambda: eng.query(q, collect="count"))
            count_warm.append(ms)
            check(c2.count == cres.count, f"{name}: count run differs")
        check(cres.count == res.count,
              f"{name}: count mode {cres.count} != bindings {res.count}")
        rows = res.rows
        check(rows.shape == (res.count, len(res.variables)),
              f"{name}: rows shape {rows.shape}")
        check(bool(((rows >= -1) & (rows < g.n_vertices)).all()),
              f"{name}: row ids outside the vertex range")
        gpu_rows[name] = rows
        queries[name] = {"count": int(res.count), "cold_ms": cold,
                         "warm_ms": sorted(warm)[1],
                         "count_cold_ms": count_cold,
                         "count_warm_ms": sorted(count_warm)[1],
                         "launches_per_query": per_query}
        log(f"  {name}: count {res.count} cold {cold:.1f} ms warm "
            f"{sorted(warm)[1]:.1f} ms count-mode warm "
            f"{sorted(count_warm)[1]:.1f} ms launches {per_query}")
    info["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    info["queries"] = queries

    t4 = time.perf_counter()
    cpu = SparqlEngine(g, maps, device="cpu")
    for name, q in LUBM_QUERIES.items():
        want = cpu.query(q)
        check(want.count == queries[name]["count"],
              f"{name}: card count {queries[name]['count']} != "
              f"CPU count {want.count}")
        check(np.array_equal(want.rows, gpu_rows[name]),
              f"{name}: card rows differ from the CPU run")
    info["cpu_check_s"] = time.perf_counter() - t4
    info["cpu_checked"] = list(LUBM_QUERIES)
    log(f"phase 5: all {len(LUBM_QUERIES)} counts and rows equal the CPU "
        f"run; peak device memory {info['peak_device_bytes']} B")
    return info


def kernel_table(torch, ops, ref, rec: Recorder, launches: dict) -> list:
    """Phase 6: each kernel at the main path's largest shapes."""
    plains = {
        "expand_filter_compact": ref.expand_filter_compact_ref,
        "edge_exists": ref.edge_exists_ref,
        "tile_membership": ref.tile_membership_ref,
        "bitmap_superset": ref.bitmap_superset_ref,
        "signature_filter": ref.signature_filter_ref,
    }
    table = []
    for name in ops.KERNELS:
        check(name in rec.calls, f"{name}: no call recorded on the main path")
        rows, args, kw = rec.calls[name]
        kern = getattr(ops, name)
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, plains[name](*args, **kw))
        check(err == 0, f"{name}: kernel differs from its plain version at "
                        f"the main path's shapes")
        ms = time_ms(torch, lambda: kern(*args, **kw))
        plain_ms = time_ms(torch, lambda: plains[name](*args, **kw))
        byts, nops, by = bound(torch, ref, name, args, kw)
        source, replaces = KERNEL_INFO[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byts / PEAK_BYTES_S, nops / PEAK_OPS_S) * 1e3,
            "bound_by": by, "library_ms": None,
            "shape_rows": rows, "bytes": byts, "ops": nops,
            "shapes": [list(a.shape) for a in args
                       if isinstance(a, torch.Tensor)],
        })
        log(f"phase 6: {name}: rows {rows} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {table[-1]['bound_ms']:.4f} ms")
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1000,
                    help="LUBM universities at full scale (default 1000)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops, ref

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 2: built {len(libs)} kernel libraries in {build_s:.1f} s")
    ptxas = {name: (_build.BUILD_DIR / f"{name}.ptxas.txt").read_text()
             for name in libs
             if (_build.BUILD_DIR / f"{name}.ptxas.txt").exists()}

    synthetic_checks(torch, ops, ref)

    bench = json.loads((ROOT / "benchmarks" / "BENCH_exec.json")
                       .read_text())["results"]
    rec = Recorder(ops)
    rec.install()
    ops.reset_launches()
    parity = run_parity(torch, bench)
    full = run_full(torch, ops, args.scale)
    launches = dict(ops.launches)
    rec.remove()
    log(f"main path launches: {launches}")
    for name in ops.KERNELS:
        check(launches[name] > 0, f"{name} was never launched on the main path")

    table = kernel_table(torch, ops, ref, rec, launches)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "parity": parity, "full": full,
              "kernels": table,
              "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in table]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
