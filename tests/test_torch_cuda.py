"""The hand-written Hopper kernels on the card.

Each kernel wrapper runs on CUDA tensors at small and main-path sizes and
must be bit-equal to its plain PyTorch version on the same inputs; the
engine on the card must answer exactly as on the CPU.  Every test needs a
CUDA device with ``nvcc`` and skips without one.  The file imports neither
JAX nor the reference package, so it runs on the GPU machine as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from torch_cases import (BITMAP_EDGE_CASES, DELTA_CASES,  # noqa: E402
                         DELTA_FIELDS, DELTA_ROW_CASES,
                         EFC_BACK_TO_BACK_CAPS, EFC_CASES, EFC_EDGE_CASES,
                         EFC_STREAM_SETS, GATHER_FIXED_CASES,
                         GATHER_RAGGED_EDGE_CASES, GATHER_SUM_CASES,
                         SIG_EDGE_CASES, TILE_RANGE_CASES, bitmap_ids_inputs,
                         bitmap_inputs, delta_inputs, delta_row_inputs,
                         edge_inputs, efc_edge_inputs, efc_inputs,
                         efc_tickets_settled, gather_close,
                         gather_fixed_inputs, gather_ragged_edge_inputs,
                         gather_sum_inputs, same, sig_inputs, tile_inputs,
                         tile_range_inputs, tt)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,b", [(17, 5), (1000, 64), (100000, 70000)])
def test_cuda_edge_exists(cuda, m, b):
    args, n_iters = edge_inputs(m, b, m + b)
    got = ops.edge_exists(*(tt(a, cuda) for a in args), n_iters=n_iters)
    torch.cuda.synchronize()
    same(got, ref.edge_exists_ref(*(tt(a, cuda) for a in args),
                                  n_iters=n_iters))


@pytest.mark.cuda
@pytest.mark.parametrize("r,ta,tb", [(1, 1, 8), (33, 7, 129), (50000, 1, 128)])
def test_cuda_tile_membership(cuda, r, ta, tb):
    a, b = tile_inputs(r, ta, tb, r + tb)
    got = ops.tile_membership(tt(a, cuda), tt(b, cuda))
    torch.cuda.synchronize()
    same(got, ref.tile_membership_ref(tt(a, cuda), tt(b, cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,ta,tb,offset", [
    (5000, 1, 4, 0), (5000, 1, 8, 0), (5000, 1, 16, 0), (32768, 1, 32, 0),
    (5000, 1, 64, 0), (5000, 1, 128, 0),  # 16-byte rows
    (5000, 1, 32, 1), (5000, 1, 12, 0), (5000, 1, 129, 0), (300, 1, 0, 0),
    (3001, 3, 8, 0), (1000, 64, 8, 0),  # staged results, several per row
    (1000, 65, 8, 0), (777, 300, 16, 2)])  # results stored in place
def test_cuda_tile_membership_contract_forms(cuda, rows, ta, tb, offset):
    """The contract form's load paths (16-byte rows where tb = 4G and b is
    aligned, 4-byte words otherwise) and result stores (staged through
    shared memory, or in place for wide TA), one launch each."""
    a, b = tile_inputs(rows, ta, tb, rows + ta + tb)
    ta_, tb_ = tt(a, cuda), _offset_view(b, cuda, offset)
    ops.reset_launches()
    got = ops.tile_membership(ta_, tb_)
    torch.cuda.synchronize()
    assert ops.launches["tile_membership"] == 1
    same(got, ref.tile_membership_ref(ta_, tb_))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILE_RANGE_CASES + [(1 << 20, 200_000, 32,
                                                      32)])
@pytest.mark.parametrize("column", [True, False])
def test_cuda_tile_membership_range_form(cuda, case, column):
    """The range form on probes out of range, degree 0, degree = tb and
    past it, every executor tb, negative candidates, a strided probe column
    (or a contiguous probe, as a self-loop passes v): one launch, bit-equal
    to the plain version's tile build and test."""
    rows, n, max_deg, tb = case
    nbr, iptr, table, v = tile_range_inputs(rows, n, max_deg, tb, rows + tb)
    ttable = tt(table, cuda)
    probe = ttable[:, 1] if column else ttable[:, 1].contiguous()
    args = (tt(v, cuda), tt(nbr, cuda))
    kw = dict(iptr=tt(iptr, cuda), probe=probe, tb=tb)
    ops.reset_launches()
    got = ops.tile_membership(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launches["tile_membership"] == 1
    same(got, ref.tile_membership_ref(*args, **kw))


@pytest.mark.cuda
def test_cuda_tile_membership_range_form_empty_adjacency(cuda):
    v = tt(np.array([0, 3, -1], np.int32), cuda)
    got = ops.tile_membership(v, tt(np.zeros(0, np.int32), cuda),
                              iptr=tt(np.zeros(4, np.int32), cuda),
                              probe=v, tb=8)
    same(got, np.zeros(3, bool))


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", [(1, 1), (257, 2), (100000, 5)])
def test_cuda_bitmap_superset(cuda, b, w):
    bm, req = bitmap_inputs(b, w, b + w)
    got = ops.bitmap_superset(tt(bm, cuda), tt(req, cuda))
    torch.cuda.synchronize()
    same(got, ref.bitmap_superset_ref(tt(bm, cuda), tt(req, cuda)))


def _offset_view(a: np.ndarray, cuda, offset: int):
    """``a`` on the card as a contiguous view ``offset`` int32 words into
    its buffer (so not 16-byte aligned for offset 1-3)."""
    flat = torch.empty(a.size + offset, dtype=torch.int32, device=cuda)
    flat[offset:] = tt(a, cuda).reshape(-1)
    return flat[offset:].view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", BITMAP_EDGE_CASES)
def test_cuda_bitmap_superset_ids_edge_cases(cuda, n, w):
    """The ids form on 1 to 9 ids and 5000, out-of-range ids, aligned and
    as an ``ids[1:]`` view: one launch, bit-equal to the plain version."""
    bm, req, ids = bitmap_ids_inputs(50, w, n + 1, n * 13 + w)
    tbm, treq, tids = tt(bm, cuda), tt(req, cuda), tt(ids, cuda)
    for view in (tids[:n], tids[1:]):
        ops.reset_launches()
        got = ops.bitmap_superset(tbm, treq, ids=view)
        torch.cuda.synchronize()
        assert ops.launches["bitmap_superset"] == 1
        same(got, ref.bitmap_superset_ref(tbm, treq, ids=view))


@pytest.mark.cuda
@pytest.mark.parametrize("v,w,n,offset", [
    (2_641_315, 1, 1 << 20, 0),   # the main path's label filter
    (200_000, 2, 100_003, 0),     # 8-byte row words
    (200_000, 2, 100_003, 1),     # 4-byte path: table not 8-byte aligned
    (200_000, 3, 100_003, 0),
    (50_000, 5, 100_003, 2),      # req in shared memory
])
def test_cuda_bitmap_superset_ids(cuda, v, w, n, offset):
    bm, req, ids = bitmap_ids_inputs(v, w, n, v + n)
    tbm, treq, tids = _offset_view(bm, cuda, offset), tt(req, cuda), \
        tt(ids, cuda)
    ops.reset_launches()
    got = ops.bitmap_superset(tbm, treq, ids=tids)
    torch.cuda.synchronize()
    assert ops.launches["bitmap_superset"] == 1
    same(got, ref.bitmap_superset_ref(tbm, treq, ids=tids))


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,offset", [(1, 1, 0), (7, 1, 0), (1 << 20, 1, 0),
                                        (100_003, 2, 0), (100_003, 3, 0),
                                        (100_003, 4, 0), (100_001, 9, 0),
                                        (100_003, 1, 1), (100_003, 2, 2),
                                        (100_003, 4, 3)])
def test_cuda_bitmap_superset_contract(cuda, b, w, offset):
    """The contract form: 4 consecutive rows a thread as 16-byte loads on an
    aligned table, per-row loads on a table view that is not 16-byte
    aligned; one launch, bit-equal to the plain version."""
    bm, req = bitmap_inputs(b, w, b + w)
    tbm, treq = _offset_view(bm, cuda, offset), tt(req, cuda)
    ops.reset_launches()
    got = ops.bitmap_superset(tbm, treq)
    torch.cuda.synchronize()
    assert ops.launches["bitmap_superset"] == 1
    same(got, ref.bitmap_superset_ref(tbm, treq))


@pytest.mark.cuda
@pytest.mark.parametrize("v,w2,b", [(1, 2, 3), (300, 4, 77),
                                    (200000, 10, 100000),
                                    (2_641_315, 2, 1 << 20)])
def test_cuda_signature_filter(cuda, v, w2, b):
    sig, ids, req = sig_inputs(v, w2, b, v + b)
    got = ops.signature_filter(tt(sig, cuda), tt(ids, cuda), tt(req, cuda))
    torch.cuda.synchronize()
    same(got, ref.signature_filter_ref(tt(sig, cuda), tt(ids, cuda),
                                       tt(req, cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,w,cap,with_mask,bound", EFC_CASES + [
    (200000, 5000, 2, 1 << 20, True, -1),
    (300000, 5000, 5, 1 << 22, False, -1),
    (300000, 5000, 1, 1 << 16, True, -1),  # total > capacity
])
def test_cuda_expand_filter_compact(cuda, r, v, w, cap, with_mask, bound):
    args, bid, _ = efc_inputs(r, v, w, r + v, with_mask, bound)
    bid_t = tt(np.int32(bid), cuda)
    got = ops.expand_filter_compact(*(tt(a, cuda) for a in args), bid_t, cap)
    torch.cuda.synchronize()
    want = ref.expand_filter_compact_ref(*(tt(a, cuda) for a in args), bid_t,
                                         cap)
    for g_, w_ in zip(got, want):
        same(g_, w_)
    # the bound id read from a parameter vector at a slot (a view)
    params = tt(np.array([5, -1, bid], np.int32), cuda)
    got = ops.expand_filter_compact(*(tt(a, cuda) for a in args), params[2],
                                    cap)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        same(g_, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w2", SIG_EDGE_CASES)
def test_cuda_signature_filter_edge_cases(cuda, n, w2):
    """1 to 9 ids around the kernel's groups of 4, out-of-range ids, on an
    aligned v and on a ``v[1:]`` view (a scalar head before the first
    16-byte boundary)."""
    sig, ids, req = sig_inputs(50, w2, n + 1, n * 11 + w2)
    tsig, tids, treq = tt(sig, cuda), tt(ids, cuda), tt(req, cuda)
    for view in (tids[:n], tids[1:]):
        got = ops.signature_filter(tsig, view, treq)
        torch.cuda.synchronize()
        same(got, ref.signature_filter_ref(tsig, view, treq))


@pytest.mark.cuda
@pytest.mark.parametrize("w2,offset", [(3, 0), (2, 1), (10, 1)])
def test_cuda_signature_filter_scalar_rows(cuda, w2, offset):
    """Rows of an odd word count, and a table view that is not 8-byte
    aligned, take the kernel's 4-byte row path."""
    sig, ids, req = sig_inputs(3000, w2, 100_003, w2 + offset)
    flat = torch.empty(sig.size + offset, dtype=torch.int32, device=cuda)
    flat[offset:] = tt(sig, cuda).reshape(-1)
    tsig = flat[offset:].view(sig.shape)
    assert tsig.is_contiguous() and (tsig.data_ptr() % 8 != 0) == offset
    tids, treq = tt(ids, cuda), tt(req, cuda)
    for view in (tids, tids[1:]):
        got = ops.signature_filter(tsig, view, treq)
        torch.cuda.synchronize()
        same(got, ref.signature_filter_ref(tsig, view, treq))


def _efc_scratch_settled() -> bool:
    torch.cuda.synchronize()
    return efc_tickets_settled(ops)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap", EFC_EDGE_CASES)
def test_cuda_expand_filter_compact_edge_cases(cuda, kind, cap):
    args, bid = efc_edge_inputs(kind, cap)
    targs = [tt(a, cuda) for a in args]
    bid_t = tt(np.int32(bid), cuda)
    ops.reset_launches()
    got = ops.expand_filter_compact(*targs, bid_t, cap)
    torch.cuda.synchronize()
    assert ops.launches["expand_filter_compact"] == 1
    want = ref.expand_filter_compact_ref(*targs, bid_t, cap)
    for g_, w_ in zip(got, want):
        same(g_, w_)
    assert _efc_scratch_settled()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap", [("all_survive", 1 << 23),
                                      ("all_survive", 1 << 24),
                                      ("last_tile_only", 1 << 23),
                                      ("total_plus_1", 1 << 23)])
def test_cuda_expand_filter_compact_large_capacity(cuda, kind, cap):
    """Capacities above 2^22 (status buffers of 8192 and 16384 tiles, grown
    from the smaller one the calls before left), with more than 2^22
    survivors where every slot survives: one launch, bit-equal."""
    args, bid = efc_edge_inputs(kind, cap)
    targs = [tt(a, cuda) for a in args]
    bid_t = tt(np.int32(bid), cuda)
    ops.reset_launches()
    got = ops.expand_filter_compact(*targs, bid_t, cap)
    torch.cuda.synchronize()
    assert ops.launches["expand_filter_compact"] == 1
    if kind == "all_survive":
        assert int(got[2]) == cap
    want = ref.expand_filter_compact_ref(*targs, bid_t, cap)
    for g_, w_ in zip(got, want):
        same(g_, w_)
    assert _efc_scratch_settled()


def _efc_sets(cuda):
    sets = []
    for r, v, w, bound in EFC_STREAM_SETS:
        args, bid, _ = efc_inputs(r, v, w, r + v, True, bound)
        sets.append(([tt(a, cuda) for a in args], tt(np.int32(bid), cuda)))
    return sets


@pytest.mark.cuda
def test_cuda_expand_filter_compact_back_to_back(cuda):
    """50 calls at mixed capacities on one stream with no sync between
    them, so each call reuses the status buffer the call before it left;
    then each result against its plain version."""
    sets = _efc_sets(cuda)
    runs = []
    for i, cap in enumerate(EFC_BACK_TO_BACK_CAPS):
        args, bid = sets[i % 3]
        runs.append((args, bid, cap,
                     ops.expand_filter_compact(*args, bid, cap)))
    torch.cuda.synchronize()
    for args, bid, cap, got in runs:
        for g_, w_ in zip(got, ref.expand_filter_compact_ref(*args, bid,
                                                             cap)):
            same(g_, w_)
    assert _efc_scratch_settled()


@pytest.mark.cuda
def test_cuda_expand_filter_compact_two_streams(cuda):
    """Calls on the default stream and on a second stream, in flight
    together: each stream has its own status buffer."""
    sets = _efc_sets(cuda)
    torch.cuda.synchronize()
    s2 = torch.cuda.Stream()
    runs = []
    for i in range(10):
        cap = (1 << 20, 1 << 14, 5000)[i % 3]
        args, bid = sets[0]
        runs.append((args, bid, cap,
                     ops.expand_filter_compact(*args, bid, cap)))
        with torch.cuda.stream(s2):
            args2, bid2 = sets[1 + i % 2]
            runs.append((args2, bid2, 4096,
                         ops.expand_filter_compact(*args2, bid2, 4096)))
    torch.cuda.synchronize()
    streams = {stream for _, stream in ops._EFC_SCRATCH}
    assert {torch.cuda.current_stream().cuda_stream, s2.cuda_stream} <= \
        streams
    for args, bid, cap, got in runs:
        for g_, w_ in zip(got, ref.expand_filter_compact_ref(*args, bid,
                                                             cap)):
            same(g_, w_)
    assert _efc_scratch_settled()


@pytest.mark.cuda
def test_cuda_expand_filter_compact_epoch_period(cuda, monkeypatch):
    """The status buffer zeroed again every few calls (the period cut from
    2^38 to 3): calls before and after each zeroing stay exact."""
    monkeypatch.setattr(ops, "_EFC_EPOCH_PERIOD", 3)
    sets = _efc_sets(cuda)
    runs = []
    for i in range(10):
        cap = (1 << 20, 5000, 1 << 14, 1 << 22)[i % 4]
        args, bid = sets[i % 2]
        runs.append((args, bid, cap,
                     ops.expand_filter_compact(*args, bid, cap)))
    torch.cuda.synchronize()
    for args, bid, cap, got in runs:
        for g_, w_ in zip(got, ref.expand_filter_compact_ref(*args, bid,
                                                             cap)):
            same(g_, w_)
    assert _efc_scratch_settled()


@pytest.mark.cuda
def test_cuda_launch_counts(cuda):
    ops.reset_launches()
    bm, req = bitmap_inputs(64, 2, 3)
    ops.bitmap_superset(tt(bm, cuda), tt(req, cuda))
    ops.bitmap_superset(tt(bm[:0], cuda), tt(req, cuda))  # empty: no launch
    assert ops.launches["bitmap_superset"] == 1
    t = tt(np.zeros(4, np.int32), cuda)
    ops.segment_gather_sum(t.float()[:, None], t, t, 2)
    ops.segment_gather_fixed(t.float()[:, None], t[:, None])
    assert ops.launches["segment_gather"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k,mb,md,mt,run,mode", DELTA_CASES + [
    (1 << 20, 1_500_000, 1 << 14, 200_000, 4000, "mixed"),  # base > 2^20
    (1 << 18, 5_926_720, 4096, 70_000, 300, "base"),
])
@pytest.mark.parametrize("n_iters", [8, 32])
def test_cuda_delta_merge(cuda, k, mb, md, mt, run, mode, n_iters):
    args, _ = delta_inputs(k, mb, md, mt, k + mb + mt, run=run,
                           vmax=max(60, mb // 2), mode=mode)
    ops.reset_launches()
    got = ops.delta_merge(*(tt(a, cuda) for a in args), n_iters=n_iters)
    torch.cuda.synchronize()
    assert ops.launches["delta_merge"] == 1
    # the wrapper pads empty arrays; the plain version sees them padded
    padded = [a if a.shape[0] or i > 2 else np.full(1, -1, np.int32)
              for i, a in enumerate(args)]
    want = ref.delta_merge_ref(*(tt(a, cuda) for a in padded),
                               n_iters=n_iters)
    for g_, w_ in zip(got, want):
        same(g_, w_)


def _delta_row_on(cuda, case, offset=0):
    """A ``DELTA_ROW_CASES`` case on the card: (arrays, given fields, row,
    j, valid, n_iters, per-slot fields); ``offset`` puts row and j at a
    view that is not 16-byte aligned."""
    k, r, mb, md, mt, run, absent, none_valid = case
    arrays, fields, row, j, valid, n_iters = delta_row_inputs(
        k, r, mb, md, mt, run, seed=k + r + mb, none_valid=none_valid)
    given = [None if name in absent else tt(f, cuda)
             for name, f in zip(DELTA_FIELDS, fields)]
    rc = np.clip(row, 0, r - 1)
    per_slot = [tt(np.zeros(k, np.int32) if name in absent else f[rc], cuda)
                for name, f in zip(DELTA_FIELDS, fields)]
    return ([tt(a, cuda) for a in arrays], given,
            _offset_view(row, cuda, offset), _offset_view(j, cuda, offset),
            tt(valid, cuda), n_iters, per_slot)


def _padded(arrays, cuda):
    """The adjacency arrays as the wrapper pads them (empty: one -1)."""
    return [a if a.shape[0] else torch.full((1,), -1, dtype=torch.int32,
                                            device=cuda) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DELTA_ROW_CASES + [
    # the main path's merged step: a 2^20-slot expansion over 65,536 rows
    (1 << 20, 1 << 16, 5_185_880, 65_536, 16_384, 40, (), False),
    (1 << 20, 1 << 16, 5_185_880, 65_536, 0, 4, ("t_lo", "t_hi"), False),
])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_delta_merge_row_form(cuda, case, offset):
    """The row form on every ``DELTA_ROW_CASES`` case and at the main
    path's size, with row and j aligned and not: one launch, bit-equal to
    the plain version's row form, and to the contract form on the per-slot
    arrays."""
    arrays, given, row, j, valid, n_iters, per_slot = _delta_row_on(
        cuda, case, offset)
    ops.reset_launches()
    got = ops.delta_merge(*arrays, *given, j, valid, n_iters=n_iters,
                          row=row)
    torch.cuda.synchronize()
    assert ops.launches["delta_merge"] == 1
    padded = _padded(arrays, cuda)
    for g_, w_ in zip(got, ref.delta_merge_ref(*padded, *given, j, valid,
                                               n_iters=n_iters, row=row)):
        same(g_, w_)
    contract = ops.delta_merge(*arrays, *per_slot, j, valid,
                               n_iters=n_iters)
    torch.cuda.synchronize()
    assert ops.launches["delta_merge"] == 2
    for c_, w_ in zip(contract, ref.delta_merge_ref(*padded, *per_slot, j,
                                                    valid, n_iters=n_iters)):
        same(c_, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics,use_fused", [("hom", True),
                                                 ("hom", False),
                                                 ("iso", True)])
def test_cuda_engine_matches_cpu(cuda, semantics, use_fused):
    from repro_torch.core import ExecOpts, SparqlEngine
    from repro_torch.rdf.generator import generate_bsbm, generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import BSBM_QUERIES, LUBM_QUERIES

    opts = ExecOpts(semantics=semantics, use_fused=use_fused)
    for make, queries in (
            (lambda: generate_lubm(scale=2, seed=0, density=0.6),
             LUBM_QUERIES),
            (lambda: generate_bsbm(n_products=300, seed=1), BSBM_QUERIES)):
        g, maps = type_aware_transform(make().finalize())
        gpu = SparqlEngine(g, maps, opts=opts)
        cpu = SparqlEngine(g, maps, opts=opts, device="cpu")
        for name, q in queries.items():
            got, want = gpu.query(q), cpu.query(q)
            assert got.count == want.count, name
            np.testing.assert_array_equal(got.rows, want.rows, err_msg=name)
            assert gpu.count(q) == want.count, name


@pytest.mark.cuda
def test_cuda_live_store_matches_cpu(cuda):
    """A live store on the card: a snapshot with inserts and deletes in
    every batch, swapped in with ``set_graph``, answers exactly as the same
    snapshot on the CPU, through ``delta_merge``."""
    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.triples import TripleStore
    from repro_torch.rdf.workloads import LUBM_QUERIES
    from repro_torch.store import VersionedStore

    st = generate_lubm(scale=2, seed=0, density=0.6).finalize()
    triples = list(st.iter_decoded())
    rng = np.random.default_rng(5)
    plain = [t for t in triples if t[1] not in ("rdf:type", "rdf:subClassOf")]
    hold = set(rng.choice(len(plain), size=len(plain) // 8, replace=False))
    ins = [plain[i] for i in sorted(hold)]
    held = set(ins)
    base = [t for t in triples if t not in held]
    bst = TripleStore()
    bst.add_many(base)
    g, maps = type_aware_transform(bst.finalize())
    store = VersionedStore(g, maps, auto_compact=False)
    gpu = SparqlEngine(store.snapshot(), maps)
    dels = [base[i] for i in rng.choice(len(base), size=50, replace=False)
            if base[i][1] not in ("rdf:type", "rdf:subClassOf")]
    ops.reset_launches()
    for b in range(2):
        store.insert_triples(ins[b::2])
        store.delete_triples(dels[b::2])
        gpu.set_graph(store.snapshot())
        cpu = SparqlEngine(store.snapshot(), maps, device="cpu")
        for name, q in LUBM_QUERIES.items():
            got, want = gpu.query(q), cpu.query(q)
            assert got.count == want.count, (b, name)
            np.testing.assert_array_equal(got.rows, want.rows, err_msg=name)
            assert gpu.count(q) == want.count, (b, name)
    assert ops.launches["delta_merge"] > 0


def _gather_on(cuda, arrs, dtype):
    table, *ids, w = arrs
    dt = getattr(torch, dtype)
    return (torch.from_numpy(table).to(cuda, dt), [tt(a, cuda) for a in ids],
            None if w is None else torch.from_numpy(w).to(cuda, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,s,k,weighted,dtype", GATHER_FIXED_CASES + [
    (1_000_000, 64, 100_000, 8, True, "float32"),
    (100_000, 100, 50_000, 40, False, "bfloat16"),
])
def test_cuda_segment_gather_fixed(cuda, v, d, s, k, weighted, dtype):
    table, (idx,), w = _gather_on(
        cuda, gather_fixed_inputs(v, d, s, k, weighted, seed=v + s), dtype)
    ops.reset_launches()
    got = ops.segment_gather_fixed(table, idx, w)
    torch.cuda.synchronize()
    assert ops.launches["segment_gather"] == 1
    want = ref.segment_gather_fixed_ref(table, idx, w)
    assert got.dtype == want.dtype
    gather_close(got, want.float().cpu().numpy(), dtype, k)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,e,s,weighted,dtype", GATHER_SUM_CASES + [
    (500_000, 100, 4_000_000, 200_000, True, "float32"),
    (200_000, 64, 2_000_000, 5_000, False, "bfloat16"),  # runs of ~400
])
def test_cuda_segment_gather_sum(cuda, v, d, e, s, weighted, dtype):
    table, (idx, seg), w = _gather_on(
        cuda, gather_sum_inputs(v, d, e, s, weighted, seed=v + e), dtype)
    got = ops.segment_gather_sum(table, idx, seg, s, w)
    torch.cuda.synchronize()
    want = ref.segment_gather_sum_ref(table, idx, seg, s, w)
    gather_close(got, want.float().cpu().numpy(), dtype, -(-e // s))


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,e,s,kind,dtype,offset",
                         GATHER_RAGGED_EDGE_CASES + [
                             (50_000, 100, 2_000_000, 80_000, "mixed",
                              "float32", 0),
                             (50_000, 100, 2_000_000, 80_000, "mixed",
                              "float32", 1)])
def test_cuda_segment_gather_sum_edge_cases(cuda, v, d, e, s, kind, dtype,
                                            offset):
    """The ragged form's hard cases on the 16-byte and 4-byte load paths:
    one launch, within tolerance of the plain version, and bit-equal to
    the same call on the other load path (an aligned copy of an unaligned
    table, or an unaligned copy of an aligned one)."""
    dt = getattr(torch, dtype)
    table, idx, seg, w = gather_ragged_edge_inputs(v, d, e, s, kind, e + d)
    tw, tidx, tseg = torch.from_numpy(w).to(cuda, dt), tt(idx, cuda), \
        tt(seg, cuda)

    def placed(off):
        flat = torch.zeros(table.size + off, dtype=dt, device=cuda)
        flat[off:] = torch.from_numpy(table).to(cuda, dt).reshape(-1)
        return flat[off:].view(table.shape)

    t_table = placed(offset)
    ops.reset_launches()
    got = ops.segment_gather_sum(t_table, tidx, tseg, s, tw)
    torch.cuda.synchronize()
    assert ops.launches["segment_gather"] == 1
    want = ref.segment_gather_sum_ref(t_table, tidx, tseg, s, tw)
    gather_close(got, want.float().cpu().numpy(), dtype, max(1, -(-e // s)))
    other = ops.segment_gather_sum(placed(1 if offset == 0 else 0), tidx,
                                   tseg, s, tw)
    torch.cuda.synchronize()
    assert torch.equal(got, other)
    if kind != "mixed":
        assert not got.float().any()


@pytest.mark.cuda
def test_cuda_segment_gather_sum_repeats_bits(cuda):
    """Two calls on the same inputs (runs of about 40 entries, some past
    150) give the same bits: each segment sums in entry order."""
    table, idx, seg, w = gather_sum_inputs(20_000, 100, 1_000_000, 25_000,
                                           True, seed=5)
    seg[:200] = 7
    args = (torch.from_numpy(table).to(cuda), tt(idx, cuda), tt(seg, cuda),
            25_000, torch.from_numpy(w).to(cuda))
    first = ops.segment_gather_sum(*args)
    second = ops.segment_gather_sum(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_param_batch_matches_cpu(cuda):
    """Query families on the card: every lane of a batch equals its own
    ``execute_param`` run and the CPU run, with a missing-constant lane and
    a capacity slack small enough that lanes overflow and rerun alone."""
    import re

    from repro_torch.core import ExecOpts, SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.serve.fingerprint import parameterize_query

    g, maps = type_aware_transform(
        generate_lubm(scale=2, seed=0, density=0.6).finalize())
    terms = maps.dict.terms.to_str
    courses = [t for t in terms if re.match(r"ub:GraduateCourse\d", t)]
    depts = [t for t in terms if re.match(r"ub:Dept\d", t)]
    students = [t for t in terms
                if re.match(r"ub:(Undergraduate|Graduate)Student\d", t)]
    families = [
        ["SELECT ?c ?t WHERE { %s ub:takesCourse ?c . ?t ub:teacherOf ?c . "
         "?t ub:worksFor ?d . }" % c for c in students[:20]],
        ["SELECT ?x WHERE { ?x rdf:type ub:GraduateStudent . "
         "?x ub:takesCourse %s . }" % c
         for c in courses[:11] + ["ub:NoSuchCourse9"]],
        ["SELECT ?x ?y WHERE { ?x rdf:type ub:Student . ?x ub:memberOf %s . "
         "?x ub:takesCourse ?y . ?y rdf:type ub:Course . "
         "?z ub:teacherOf ?y . ?z ub:worksFor %s . }"
         % (d, depts[(i * 7) % len(depts)] if i % 2 else d)
         for i, d in enumerate(depts[:9])],
    ]
    cpu = SparqlEngine(g, maps, device="cpu")
    for opts in (ExecOpts(), ExecOpts(cap_slack=1 / 16)):
        gpu = SparqlEngine(g, maps, opts=opts)
        for qs in families:
            pqs = [parameterize_query(q) for q in qs]
            fam, cfam = gpu.compile_param(pqs[0]), cpu.compile_param(pqs[0])
            for collect in ("bindings", "count"):
                got = gpu.execute_param_batch(fam, [pq.consts for pq in pqs],
                                              collect)
                for r, pq in zip(got, pqs):
                    for want in (gpu.execute_param(fam, pq.consts, collect),
                                 cpu.execute_param(cfam, pq.consts, collect)):
                        assert r.count == want.count
                        np.testing.assert_array_equal(r.rows, want.rows)


@pytest.mark.cuda
def test_cuda_scheduler_threads_match_cpu(cuda):
    """The serving path on the card, the port's first engine run from many
    threads: a ``DatasetRegistry`` with a static and a live dataset and a
    ``Scheduler`` with 4 workers, fed by 8 client threads of mixed LUBM
    queries (some with a forced trace) and family members that batch.
    Every answer equals the CPU engine's, and every engine kernel of the
    two paths launched."""
    import re
    import sys
    import threading

    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.server import DatasetRegistry
    from repro_torch.store import VersionedStore

    g, maps = type_aware_transform(
        generate_lubm(scale=2, seed=0, density=0.6).finalize())
    store = VersionedStore(g, maps, auto_compact=False)
    store.apply_update("INSERT DATA { ub:SrvS rdf:type ub:GraduateStudent . "
                       "ub:SrvS ub:takesCourse ub:GraduateCourse0.Dept0."
                       "Univ0 . ub:SrvS ub:advisor ub:FullProfessor0.Dept0."
                       "Univ0 . }")
    courses = [t for t in maps.dict.terms.to_str
               if re.match(r"ub:GraduateCourse\d", t)][:16]
    texts = list(LUBM_QUERIES.values()) + [
        "SELECT ?x WHERE { ?x rdf:type ub:GraduateStudent . "
        "?x ub:takesCourse %s . }" % c for c in courses]
    want = {}
    for name, graph in (("lubm", g), ("live", store.snapshot())):
        cpu = SparqlEngine(graph, maps, device="cpu")
        for t in texts:
            r = cpu.query(t)
            want[name, t] = (r.count, sorted(map(tuple, r.rows.tolist())))
    reg = DatasetRegistry()
    reg.register("lubm", g, maps)
    reg.register("live", g, maps, updatable=True, store=store)
    sched = Scheduler(reg, workers=4, batch_max=64, batch_window_ms=20.0,
                      metrics=reg.metrics).start()
    got, errors = [], []
    start = threading.Barrier(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    ops.reset_launches()
    try:
        def client(k):
            try:
                start.wait(timeout=60)
                ds = ("lubm", "live")[k % 2]
                for i, t in enumerate(texts[k:] + texts[:k]):
                    r = sched.submit(ds, t, timeout_s=300.0,
                                     trace=(i + k) % 7 == 0)
                    got.append((ds, t, r.count,
                                sorted(map(tuple, r.rows.tolist()))))
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600.0)
        assert not any(t.is_alive() for t in threads)
        # the family's members all at once: the first one's 20 ms batch
        # window gathers the others into one batch program
        burst = texts[len(LUBM_QUERIES):]
        together = threading.Barrier(len(burst))

        def member(k):
            try:
                together.wait(timeout=60)
                r = sched.submit("lubm", burst[k], timeout_s=300.0)
                got.append(("lubm", burst[k], r.count,
                            sorted(map(tuple, r.rows.tolist()))))
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=member, args=(k,))
                   for k in range(len(burst))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        sched.stop()
    assert not errors, errors[:3]
    assert len(got) == 8 * len(texts) + len(burst)
    for ds, t, count, rows in got:
        assert (count, rows) == want[ds, t], (ds, t)
    for name in ("expand_filter_compact", "edge_exists", "bitmap_superset",
                 "signature_filter", "delta_merge"):
        assert ops.launches[name] > 0, name
    assert reg.metrics.coalesced_queries.total() >= 2


@pytest.mark.cuda
def test_cuda_profiled_step_time_excludes_other_threads(cuda):
    """A forced trace times each step on a stream of its own: while another
    thread keeps the default stream queued with long kernels (each a spin
    of one thread, so the card's SMs stay free), a device-wide sync waits
    for them, but a profiled step's time holds its own work only."""
    import threading
    import time

    from repro_torch.core import SparqlEngine
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES

    g, maps = type_aware_transform(
        generate_lubm(scale=2, seed=0, density=0.6).finalize())
    eng = SparqlEngine(g, maps)
    q = LUBM_QUERIES["Q9"]
    want = SparqlEngine(g, maps, device="cpu").query(q)
    for _ in range(2):
        eng.query(q, trace=True)  # build every per-step program
    spin = 50_000_000  # clock cycles, tens of ms
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.cuda._sleep(spin)
    e1.record()
    e1.synchronize()
    load_ms = e0.elapsed_time(e1)
    stop = threading.Event()

    def load():
        done = []
        while not stop.is_set():
            torch.cuda._sleep(spin)
            ev = torch.cuda.Event()
            ev.record()
            done.append(ev)
            if len(done) > 3:
                done.pop(0).synchronize()
        torch.cuda.synchronize()

    loader = threading.Thread(target=load)
    loader.start()
    try:
        time.sleep(3 * load_ms / 1e3)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t0) * 1e3
        runs = [eng.query(q, trace=True) for _ in range(3)]
    finally:
        stop.set()
        loader.join(timeout=60.0)
    assert not loader.is_alive()
    assert load_ms > 5 and sync_ms > load_ms / 2, (sync_ms, load_ms)
    for res in runs:
        assert res.count == want.count
        np.testing.assert_array_equal(res.rows, want.rows)
        base = res.stats["exec"]["branches"][0]["base"]
        steps = base["step_wall_ms"]
        assert max(steps) < load_ms / 2, (steps, load_ms)
        spans = res.stats["trace_obj"].find("step")
        assert [s.meta["kernel"] for s in spans] == base["step_kernels"]
        assert all(s.meta["model_ms"] > 0 for s in spans)


# ------------------------------------------------------- sharded execution
@pytest.fixture
def nccl_mesh(cuda):
    """A world of one NCCL rank and its (pod, data, model) = (1, 1, 1)
    mesh (NCCL refuses two ranks on one card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.sharded import free_port

    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_run_sharded_nccl_matches_executor(nccl_mesh):
    """Every LUBM query (scale 1) through ``run_sharded`` on the card
    equals ``Executor.run`` on the card and on the CPU."""
    from repro_torch.core import (ExecOpts, Executor, build_plan,
                                  build_query_graph, run_sharded)
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.sparql import parse_sparql
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.workloads import LUBM_QUERIES

    g, maps = type_aware_transform(
        generate_lubm(scale=1, seed=0, density=0.3).finalize())
    gpu = Executor(g, ExecOpts())
    cpu = Executor(g, ExecOpts(), device="cpu")
    ops.reset_launches()
    for name, text in LUBM_QUERIES.items():
        q = build_query_graph(parse_sparql(text).where.triples, maps)
        plan = build_plan(g, q, device="cpu")
        got = run_sharded(gpu, plan, nccl_mesh)
        assert got == gpu.run(plan, collect="count").count == \
            cpu.run(plan, collect="count").count, name
    assert ops.launches["expand_filter_compact"] > 0


def _path_step_inputs(seed, n, m):
    from repro_torch.core import build_plan
    from repro_torch.core.query import QEdge, QueryGraph, QVertex
    from repro_torch.rdf.graph import LabeledGraph

    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = LabeledGraph.build(n, src, np.zeros(m, np.int64), dst, 1, [(0,)] * n,
                           1)
    q = QueryGraph()
    for i in range(4):
        q.vertices.append(QVertex(f"v{i}", labels=(0,)))
        q.var_to_vertex[f"v{i}"] = i
    q.edges = [QEdge(0, 1, 0), QEdge(1, 2, 0), QEdge(2, 3, 0)]
    plan = build_plan(g, q, estimate="static", force_order=[0, 1, 2, 3],
                      device="cpu")
    arrays = (np.ascontiguousarray(g.out.nbr_el, np.int32),
              np.stack([g.out.indptr_el[0]] * 3).astype(np.int32),
              g.label_bitmap.view(np.int32))
    return g, plan, arrays


@pytest.mark.cuda
def test_cuda_engine_chunk_step_matches_cpu_and_executor(cuda):
    """Chunk by chunk, the step on the card equals its CPU run, through
    the card's bitmap_superset and edge_exists; summed, it equals the
    executor's path count on the card."""
    from repro_torch.core import ExecOpts, Executor, engine_chunk_step

    g, plan, arrays = _path_step_inputs(0, 50_000, 120_000)
    want = Executor(g, ExecOpts()).run(plan, collect="count").count
    on_card = [tt(a, cuda) for a in arrays]
    on_cpu = [torch.from_numpy(a) for a in arrays]
    cands = plan.start_candidates
    total = 0
    ops.reset_launches()
    for lo in range(0, cands.shape[0], 4096):
        chunk = np.full(4096, -1, np.int32)
        part = cands[lo:lo + 4096]
        chunk[: part.shape[0]] = part
        c, o = engine_chunk_step(*on_card, tt(chunk, cuda), part.shape[0],
                                 cap=1 << 17, n_steps=3)
        cc, oc = engine_chunk_step(*on_cpu, torch.from_numpy(chunk),
                                   part.shape[0], cap=1 << 17, n_steps=3)
        assert c.is_cuda and (int(c), bool(o)) == (int(cc), bool(oc)), lo
        assert not bool(o)
        total += int(c)
    assert total == want
    assert ops.launches["bitmap_superset"] > 0
    assert ops.launches["edge_exists"] > 0


@pytest.mark.cuda
def test_cuda_timed_waits_for_nested_results(cuda):
    """``timed`` waits for the card's work behind a result nested in a
    dict, a list and an executor ``Result``: each call's time covers a
    spin of about 20 ms, not only its enqueue."""
    import time

    from repro_torch.core.exec import Result
    from repro_torch.utils import timed

    x = torch.ones(4, device=cuda)

    def work():
        torch.cuda._sleep(1 << 25)
        return {"out": [Result(1, None, None, stats={"t": x + 1})]}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = time.perf_counter() - t0
    res, sec = timed(work, repeats=3, warmup=1)
    assert float(res["out"][0].stats["t"].sum()) == 8.0
    assert sec > spin / 2 > enqueue, (sec, spin, enqueue)


# ------------------------------------------------------------ model zoo


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_embedding_bag_forward_backward_match_cpu(cuda, weighted):
    """``EmbeddingBagSum`` on the card (the kernel forward, one launch; the
    ``index_add_`` backward) against the same call on the CPU (the plain
    version), on zipf-drawn ids with padding, ids >= V and hot rows.  The
    unweighted forward is bit-equal (both sum in entry order).  The
    table's gradient sums each row's n contributions in another order
    (the card's float atomics, in no fixed order): any two orders of a
    float32 sum differ by at most 2·(n-1)·2^-24·Σ|terms|, which is the
    tolerance of each element (the hottest row takes about 1,400 terms).
    The weights' gradient is a 64-term dot product a slot: rtol = atol =
    1e-5."""
    rng = np.random.default_rng(9)
    v, d, s, k = 50_000, 64, 8192, 8
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = (rng.zipf(1.2, size=(s, k)) % (v + 100) - 1).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (s, k)).astype(np.float32)
    d_out = rng.normal(size=(s, d)).astype(np.float32)

    def run(device):
        t = torch.from_numpy(table).to(device).requires_grad_()
        ws = torch.from_numpy(w).to(device).requires_grad_() \
            if weighted else None
        out = ops.embedding_bag_sum(t, torch.from_numpy(idx).to(device), ws)
        out.backward(torch.from_numpy(d_out).to(device))
        return [None if x is None else x.detach().cpu()
                for x in (out, t.grad, None if ws is None else ws.grad)]

    ops.reset_launches()
    got = run(cuda)
    torch.cuda.synchronize()
    assert ops.launches["segment_gather"] == 1
    want = run("cpu")
    if not weighted:
        assert torch.equal(got[0], want[0])
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    # each table element's terms: d_out[s] (times w[s, k]) for each valid
    # slot reading its row
    keep = idx >= 0
    rows = torch.from_numpy(np.minimum(idx, v - 1)[keep]).long()
    terms = torch.from_numpy(d_out)[:, None, :] * (
        torch.from_numpy(w)[:, :, None] if weighted else 1.0)
    terms = terms.expand(s, k, d)[torch.from_numpy(keep)]
    abs_sum = torch.zeros(v, d).index_add_(0, rows, terms.abs())
    n = torch.zeros(v).index_add_(0, rows, torch.ones(rows.shape[0]))
    bound = 2 * (n - 1).clamp(min=0)[:, None] * 2.0**-24 * abs_sum
    assert bool(((got[1] - want[1]).abs() <= bound).all())


@pytest.mark.cuda
def test_cuda_dlrm_small_step_matches_cpu(cuda):
    """One DLRM ``SMALL`` train step on the card against the same step on
    the CPU from the same weights and batch: loss, gradient norm and the
    weights after AdamW.  The step's update is close to sign(g)·lr
    (3e-3), so a gradient the two devices round apart near 0 may move a
    weight by up to 2·lr; every other weight agrees within 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import model_for
    from repro_torch.train.data import RecsysStream
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import make_train_step, named_params

    arch = get_arch("dlrm-rm2")
    cfg = arch.smoke()[0]
    batch = RecsysStream(cfg.n_dense, cfg.n_sparse, cfg.hotness,
                         cfg.vocab_sizes, batch=256, seed=3).batch_at(0)
    opt = OptConfig(lr=3e-3, warmup_steps=1)
    out = {}
    for device in ("cpu", cuda):
        model = model_for(arch, cfg, device,
                          torch.Generator(device="cpu").manual_seed(0)
                          if device == "cpu" else None)
        if device != "cpu":
            model.load_state_dict(out["cpu"][2])
        state = adamw_init(named_params(model), opt)
        start = {k: t.detach().cpu().clone()
                 for k, t in model.state_dict().items()}
        ops.reset_launches()
        _, _, m = make_train_step(arch.loss_fn, model, opt)(model, state,
                                                            batch)
        if device != "cpu":
            torch.cuda.synchronize()
            assert ops.launches["segment_gather"] == cfg.n_sparse
        out[str(torch.device(device).type)] = (
            float(m["loss"]), float(m["grad_norm"]), start,
            {k: t.detach().cpu() for k, t in model.state_dict().items()})
    (l_cpu, g_cpu, _, p_cpu), (l_gpu, g_gpu, _, p_gpu) = out["cpu"], \
        out["cuda"]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    assert g_gpu == pytest.approx(g_cpu, rel=1e-4)
    for k, want in p_cpu.items():
        diff = (p_gpu[k] - want).abs()
        assert float(diff.max()) <= 2 * 3e-3 + 1e-6, k
        assert float((diff > 1e-5).float().mean()) <= 0.01, k
