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
from torch_cases import (DELTA_CASES, EFC_CASES, bitmap_inputs,  # noqa: E402
                         delta_inputs, edge_inputs, efc_inputs, same,
                         sig_inputs, tile_inputs, tt)


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
@pytest.mark.parametrize("b,w", [(1, 1), (257, 2), (100000, 5)])
def test_cuda_bitmap_superset(cuda, b, w):
    bm, req = bitmap_inputs(b, w, b + w)
    got = ops.bitmap_superset(tt(bm, cuda), tt(req, cuda))
    torch.cuda.synchronize()
    same(got, ref.bitmap_superset_ref(tt(bm, cuda), tt(req, cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("v,w2,b", [(1, 2, 3), (300, 4, 77),
                                    (200000, 10, 100000)])
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
    got = ops.expand_filter_compact(*(tt(a, cuda) for a in args), bid, cap)
    torch.cuda.synchronize()
    want = ref.expand_filter_compact_ref(*(tt(a, cuda) for a in args), bid,
                                         cap)
    for g_, w_ in zip(got, want):
        same(g_, w_)


@pytest.mark.cuda
def test_cuda_launch_counts(cuda):
    ops.reset_launches()
    bm, req = bitmap_inputs(64, 2, 3)
    ops.bitmap_superset(tt(bm, cuda), tt(req, cuda))
    ops.bitmap_superset(tt(bm[:0], cuda), tt(req, cuda))  # empty: no launch
    assert ops.launches["bitmap_superset"] == 1
    with pytest.raises(NotImplementedError):
        t = tt(np.zeros(4, np.int32), cuda)
        ops.segment_gather_sum(t.float()[:, None], t, t, 2)


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
