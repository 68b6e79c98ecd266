"""Kernel parity: the port's plain PyTorch versions against the reference.

Seeded numpy inputs go through ``repro.kernels.ref`` (and, for the six
kernels on the engine's paths, the Pallas kernel in interpret mode) and
through ``repro_torch.kernels``; integer and boolean outputs must be
bit-equal.  Bitmap words go to torch as int32 bit patterns of the same
uint32 values.  ``test_torch_cuda.py`` holds each hand-written Hopper
kernel against its plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitmap_filter import bitmap_superset_pallas  # noqa: E402
from repro.kernels.edge_exists import edge_exists_pallas  # noqa: E402
from repro.kernels.expand_filter import expand_filter_compact_pallas  # noqa: E402
from repro.kernels.signature_filter import signature_filter_pallas  # noqa: E402
from repro.kernels.sorted_intersect import tile_membership_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro.kernels.delta_merge import delta_merge_pallas  # noqa: E402
from repro.kernels.segment_gather import (  # noqa: E402
    segment_gather_fixed_pallas, segment_gather_sum_pallas)
from torch_cases import (BITMAP_EDGE_CASES, DELTA_CASES,  # noqa: E402
                         DELTA_FIELDS, DELTA_ROW_CASES, EFC_CASES,
                         EFC_EDGE_CASES, GATHER_FIXED_CASES, GATHER_SUM_CASES,
                         GATHER_RAGGED_EDGE_CASES, SIG_EDGE_CASES,
                         TILE_RANGE_CASES, bitmap_ids_inputs, bitmap_inputs,
                         delta_inputs, delta_row_inputs, edge_inputs,
                         efc_edge_inputs, efc_inputs, gather_close,
                         gather_fixed_inputs, gather_ragged_edge_inputs,
                         gather_sum_inputs, same, sig_inputs, tile_inputs,
                         tile_range_inputs, tile_range_tile, tt)


# ---------------------------------------------- plain version vs reference


@pytest.mark.parametrize("m,b", [(1, 1), (17, 5), (1000, 64), (100, 300)])
def test_edge_exists(m, b):
    args, n_iters = edge_inputs(m, b, m * 31 + b)
    want = jref.edge_exists_ref(*map(jnp.asarray, args), n_iters=n_iters)
    pallas = edge_exists_pallas(*map(jnp.asarray, args), n_iters=n_iters,
                                interpret=True, tile=64)
    got = ref.edge_exists_ref(*map(tt, args), n_iters=n_iters)
    same(got, want)
    same(got, pallas)
    same(ops.edge_exists(*map(tt, args), n_iters=n_iters), want)


@pytest.mark.parametrize("r,ta,tb", [(1, 1, 1), (4, 8, 16), (33, 7, 129),
                                     (256, 1, 64), (50, 1, 128)])
def test_tile_membership(r, ta, tb):
    a, b = tile_inputs(r, ta, tb, r * 1000 + ta + tb)
    want = jref.tile_membership_ref(jnp.asarray(a), jnp.asarray(b))
    pallas = tile_membership_pallas(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True, row_tile=16)
    got = ops.tile_membership(tt(a), tt(b))
    same(got, want)
    same(got, pallas)


@pytest.mark.parametrize("rows,n,max_deg,tb", TILE_RANGE_CASES)
def test_tile_membership_range_form(rows, n, max_deg, tb):
    """The range form (the engine's +INT call) equals the TPU kernel in
    interpret mode on the tile built as the reference executor builds it
    (``repro/core/exec.py``'s ``adj_tile``): probes out of range, degree 0
    and degree = tb, degrees past tb, negative candidates, a strided probe
    column."""
    nbr, iptr, table, v = tile_range_inputs(rows, n, max_deg, tb, rows + tb)
    tile = jnp.asarray(tile_range_tile(nbr, iptr, table[:, 1], tb))
    pallas = tile_membership_pallas(jnp.asarray(v)[:, None], tile,
                                    interpret=True, row_tile=4096)
    ttable = tt(table)
    got = ops.tile_membership(tt(v), tt(nbr), iptr=tt(iptr),
                              probe=ttable[:, 1], tb=tb)
    same(got, pallas[:, 0])
    same(got, jref.tile_membership_ref(jnp.asarray(v)[:, None], tile)[:, 0])
    if rows > 100:
        assert got.any() and not got.all()


def test_tile_membership_range_form_empty_adjacency():
    """An empty adjacency holds nothing (the reference reads its clamped
    gather as -2 tiles)."""
    got = ops.tile_membership(tt(np.array([0, 3, -1], np.int32)),
                              tt(np.zeros(0, np.int32)),
                              iptr=tt(np.zeros(4, np.int32)),
                              probe=tt(np.array([0, 5, -2], np.int32)), tb=8)
    same(got, np.zeros(3, bool))


@pytest.mark.parametrize("b,w", [(1, 1), (100, 1), (257, 2), (64, 5)])
def test_bitmap_superset(b, w):
    bm, req = bitmap_inputs(b, w, b + w)
    want = jref.bitmap_superset_ref(jnp.asarray(bm), jnp.asarray(req))
    pallas = bitmap_superset_pallas(jnp.asarray(bm), jnp.asarray(req),
                                    interpret=True, tile=64)
    got = ops.bitmap_superset(tt(bm), tt(req))
    same(got, want)
    same(got, pallas)
    if b > 3:
        assert got.any() and not got.all()


@pytest.mark.parametrize("n,w", BITMAP_EDGE_CASES)
def test_bitmap_superset_ids(n, w):
    """The ids form (the engine's label and NLF filters) equals the TPU
    kernel in interpret mode on the rows gathered at the clamped ids: 1 to 9
    ids and 5000, negative and out-of-range ids, on aligned ids and on an
    ``ids[1:]`` view."""
    bm, req, ids = bitmap_ids_inputs(50, w, n + 1, n * 13 + w)
    tbm, treq, tids = tt(bm), tt(req), tt(ids)
    tile = 4 if n < 16 else 1024
    for part, view in ((ids[:n], tids[:n]), (ids[1:], tids[1:])):
        rows = jnp.asarray(bm[np.clip(part, 0, bm.shape[0] - 1)])
        pallas = bitmap_superset_pallas(rows, jnp.asarray(req),
                                        interpret=True, tile=tile)
        got = ops.bitmap_superset(tbm, treq, ids=view)
        same(got, pallas)
        same(got, jref.bitmap_superset_ref(rows, jnp.asarray(req)))
    if n > 100:
        assert got.any() and not got.all()


@pytest.mark.parametrize("v,w2,b", [(1, 2, 3), (50, 2, 100), (300, 4, 77),
                                    (40, 10, 64)])
def test_signature_filter(v, w2, b):
    sig, ids, req = sig_inputs(v, w2, b, v * 7 + b)
    want = jref.signature_filter_ref(jnp.asarray(sig), jnp.asarray(ids),
                                     jnp.asarray(req))
    pallas = signature_filter_pallas(jnp.asarray(sig), jnp.asarray(ids),
                                     jnp.asarray(req), interpret=True,
                                     tile=32)
    got = ops.signature_filter(tt(sig), tt(ids), tt(req))
    same(got, want)
    same(got, pallas)




@pytest.mark.parametrize("r,v,w,cap,with_mask,bound", EFC_CASES)
def test_expand_filter_compact(r, v, w, cap, with_mask, bound):
    args, bid, total = efc_inputs(r, v, w, r * 13 + v + w, with_mask, bound)
    jargs = [jnp.asarray(a) for a in args]
    want = jref.expand_filter_compact_ref(*jargs, jnp.int32(bid), cap)
    pallas = expand_filter_compact_pallas(*jargs, jnp.int32(bid),
                                          capacity=cap, interpret=True,
                                          tile=16)
    got = ops.expand_filter_compact(*map(tt, args), tt(np.int32(bid)), cap)
    for g_, w_, p_ in zip(got, want, pallas):
        same(g_, w_)
        same(g_, p_)
    if cap < total:
        assert int(got[2]) <= cap
    # the bound id read from a parameter vector at a slot (a view)
    params = tt(np.array([7, bid, -1], np.int32))
    for g_, w_ in zip(ops.expand_filter_compact(*map(tt, args), params[1],
                                                cap), want):
        same(g_, w_)


@pytest.mark.parametrize("n,w2", SIG_EDGE_CASES)
def test_signature_filter_edge_cases(n, w2):
    """1 to 9 ids (the kernel's scalar head and tail around its groups of
    4), out-of-range ids, on an aligned v and on a ``v[1:]`` view."""
    sig, ids, req = sig_inputs(50, w2, n + 1, n * 11 + w2)
    tids = tt(ids)
    for part, view in ((ids[:n], tids[:n]), (ids[1:], tids[1:])):
        want = jref.signature_filter_ref(jnp.asarray(sig), jnp.asarray(part),
                                         jnp.asarray(req))
        pallas = signature_filter_pallas(jnp.asarray(sig), jnp.asarray(part),
                                         jnp.asarray(req), interpret=True,
                                         tile=4)
        got = ops.signature_filter(tt(sig), view, tt(req))
        same(got, want)
        same(got, pallas)


@pytest.mark.parametrize("kind,cap", EFC_EDGE_CASES)
def test_expand_filter_compact_edge_cases(kind, cap):
    """The shapes the one-launch kernel finds hard (every slot surviving at
    capacity 2^22, none, survivors only in the last tile, total = capacity
    +- 1, long zero-degree runs, a bound id matching one slot) against the
    reference's plain version and, up to capacity 2^16, its TPU kernel in
    interpret mode."""
    args, bid = efc_edge_inputs(kind, cap)
    jargs = [jnp.asarray(a) for a in args]
    want = jref.expand_filter_compact_ref(*jargs, jnp.int32(bid), cap)
    got = ops.expand_filter_compact(*map(tt, args), tt(np.int32(bid)), cap)
    for g_, w_ in zip(got, want):
        same(g_, w_)
    if cap <= 1 << 16:
        pallas = expand_filter_compact_pallas(*jargs, jnp.int32(bid),
                                              capacity=cap, interpret=True,
                                              tile=512)
        for g_, p_ in zip(got, pallas):
            same(g_, p_)
    count = int(got[2])
    expect = {"all_survive": cap, "none_survive": 0, "last_tile_only": 3,
              "bound_one": 1}
    if kind in expect:
        assert count == expect[kind]
    else:
        assert count > 0


def test_expand_filter_compact_above_2_22():
    """A capacity of 2^23 with more than 2^22 survivors (the capacity the
    compaction kernel once refused) against the reference's oracle."""
    cap = 1 << 23
    rng = np.random.default_rng(23)
    deg = np.full(cap // 4 + 5, 4, np.int32)
    nbr = rng.integers(0, 64, size=int(deg.sum())).astype(np.int32)
    offs = (np.cumsum(deg) - deg).astype(np.int32)
    bitmap = rng.integers(0, 2**32, size=(64, 1),
                          dtype=np.uint64).astype(np.uint32)
    bitmap |= 1
    bitmap[::8] = 0  # an eighth of the ids fail the mask
    mask = np.array([1], np.uint32)
    args = (nbr, bitmap, offs, deg, offs, mask)
    want = jref.expand_filter_compact_ref(*map(jnp.asarray, args),
                                          jnp.int32(-1), cap)
    got = ops.expand_filter_compact(*map(tt, args), tt(np.int32(-1)), cap)
    assert int(got[2]) > 1 << 22
    for g_, w_ in zip(got, want):
        same(g_, w_)


def test_expand_filter_compact_bound_filters_everything_else():
    args, bid, _ = efc_inputs(30, 12, 1, 5, with_mask=False)
    v_out, row_out, count = ops.expand_filter_compact(
        *map(tt, args), tt(np.int32(bid)), 256)
    c = int(count)
    assert c > 0 and bool((v_out[:c] == bid).all())
    assert bool((v_out[c:] == -1).all()) and bool((row_out[c:] == -1).all())


@pytest.mark.parametrize("degs,cap", [([0, 3, 0, 2], 8), ([5], 4),
                                      ([1, 1, 1, 1, 1, 1], 16),
                                      ([0, 0, 7, 0, 9, 1], 32)])
def test_ragged_expand(degs, cap):
    deg = np.array(degs, np.int32)
    offs = (np.cumsum(deg) - deg).astype(np.int32)
    want = jref.ragged_expand_ref(jnp.asarray(offs), jnp.asarray(deg), cap)
    got = ops.ragged_expand(tt(offs), tt(deg), cap)
    for g_, w_ in zip(got, want):
        same(g_, w_)


@pytest.mark.parametrize("k,mb,md,mt", [(1, 1, 1, 1), (64, 40, 10, 8),
                                        (300, 200, 50, 30)])
def test_delta_merge(k, mb, md, mt):
    args, _ = delta_inputs(k, mb, md, mt, k + mb)
    want = jref.delta_merge_ref(*map(jnp.asarray, args), n_iters=8)
    got = ops.delta_merge(*map(tt, args), n_iters=8)
    for g_, w_ in zip(got, want):
        same(g_, w_)


@pytest.mark.parametrize("k,mb,md,mt,run,mode", DELTA_CASES)
@pytest.mark.parametrize("n_iters", [8, 32])
def test_delta_merge_edge_cases(k, mb, md, mt, run, mode, n_iters):
    """Empty arrays, all-base / all-delta rows and tombstone runs longer
    than 256 against the TPU kernel in interpret mode (it pads empty arrays
    to one slot of -1, as the port's wrapper does) and, where no array is
    empty, against the reference's plain version too."""
    args, _ = delta_inputs(k, mb, md, mt, k + mb + mt, run=run,
                           vmax=max(60, mb // 2), mode=mode)
    got = ops.delta_merge(*map(tt, args), n_iters=n_iters)
    want = delta_merge_pallas(*map(jnp.asarray, args), n_iters=n_iters,
                              interpret=True)
    for g_, w_ in zip(got, want):
        same(g_, w_)
    if mb and md and mt:
        want = jref.delta_merge_ref(*map(jnp.asarray, args), n_iters=n_iters)
        for g_, w_ in zip(got, want):
            same(g_, w_)


@pytest.mark.parametrize("k,r,mb,md,mt,run,absent,none_valid",
                         DELTA_ROW_CASES)
def test_delta_merge_row_form(k, r, mb, md, mt, run, absent, none_valid):
    """The row form (the engine's merged step: row-level fields, each slot
    reading its clamped row) equals the TPU kernel in interpret mode on the
    per-slot arrays ``field[clip(row)]``, an absent field read as zeros;
    and the contract form on those arrays equals it too."""
    arrays, fields, row, j, valid, n_iters = delta_row_inputs(
        k, r, mb, md, mt, run, seed=k + r + mb, none_valid=none_valid)
    given = [None if name in absent else f
             for name, f in zip(DELTA_FIELDS, fields)]
    rc = np.clip(row, 0, r - 1)
    per_slot = [np.zeros(k, np.int32) if f is None else f[rc] for f in given]
    want = delta_merge_pallas(*map(jnp.asarray, (*arrays, *per_slot, j,
                                                 valid)),
                              n_iters=n_iters, interpret=True)
    got = ops.delta_merge(*map(tt, arrays),
                          *(None if f is None else tt(f) for f in given),
                          tt(j), tt(valid), n_iters=n_iters, row=tt(row))
    for g_, w_ in zip(got, want):
        same(g_, w_)
    contract = ops.delta_merge(*map(tt, arrays), *map(tt, per_slot), tt(j),
                               tt(valid), n_iters=n_iters)
    for c_, w_ in zip(contract, want):
        same(c_, w_)
    if none_valid:
        assert bool((got[0] == -1).all()) and not bool(got[1].any())
    elif k > 100:
        assert bool(got[1].any())
    if run > 256:  # tombstones hit
        assert bool((tt(valid) & ~got[1]).any())


@pytest.mark.parametrize("k,mb,md,mt", [(1, 1, 1, 1), (128, 60, 20, 12)])
def test_delta_merge_labeled(k, mb, md, mt):
    args, n_el = delta_inputs(k, mb, md, mt, 3 * k + md, labeled=True)
    want = jref.delta_merge_labeled_ref(*map(jnp.asarray, args), n_el,
                                        n_iters=8)
    got = ops.delta_merge_labeled(*map(tt, args), n_el, n_iters=8)
    for g_, w_ in zip(got, want):
        same(g_, w_)


@pytest.mark.parametrize("v,d,e,s,weighted", [(8, 4, 20, 5, False),
                                              (50, 16, 300, 40, True)])
def test_segment_gather_sum(v, d, e, s, weighted):
    rng = np.random.default_rng(v + e)
    # small integers: every float32 sum is exact, whatever its order
    table = rng.integers(-8, 8, size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=e).astype(np.int32)
    seg = rng.integers(0, s, size=e).astype(np.int32)
    w = rng.integers(-2, 3, size=e).astype(np.float32) if weighted else None
    want = jref.segment_gather_sum_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), s,
        weights=None if w is None else jnp.asarray(w))
    got = ops.segment_gather_sum(tt(table), tt(idx), tt(seg), s,
                                 weights=None if w is None else tt(w))
    same(got, want)


def test_expand_filter_compact_bound_slot_outside_raises():
    args, bid, _ = efc_inputs(10, 16, 1, 3)
    # a whole parameter vector where one slot's view belongs
    params = tt(np.array([bid, -1], np.int32))
    with pytest.raises(ValueError, match="bound id of 2 elements"):
        ops.expand_filter_compact(*map(tt, args), params, 64)


def _jnp(x):
    """numpy -> jax, bfloat16 through float32 (numpy has no bfloat16)."""
    if x is None:
        return None
    return jnp.asarray(x)


def _gather_args(arrs, dtype):
    """The same inputs for both packages: float arrays rounded to the
    case's dtype first, so both see identical values."""
    table, *rest, w = arrs
    tt_table = torch.from_numpy(table).to(dtype)
    j_table = jnp.asarray(tt_table.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tw = None if w is None else torch.from_numpy(w).to(dtype)
    jw = None if w is None else jnp.asarray(tw.float().numpy()).astype(
        j_table.dtype)
    return (tt_table, [tt(a) for a in rest], tw), (j_table,
                                                   [jnp.asarray(a)
                                                    for a in rest], jw)


@pytest.mark.parametrize("v,d,s,k,weighted,dtype", GATHER_FIXED_CASES)
def test_segment_gather_fixed(v, d, s, k, weighted, dtype):
    """The fixed layout against the TPU kernel in interpret mode: -1 pads,
    an index >= V reads row V-1, all-padding rows sum to zero."""
    dt = getattr(torch, dtype)
    arrs = gather_fixed_inputs(v, d, s, k, weighted, seed=v + s + k)
    (t_table, (t_idx,), t_w), (j_table, (j_idx,), j_w) = _gather_args(
        arrs, dt)
    got = ops.segment_gather_fixed(t_table, t_idx, weights=t_w)
    want = segment_gather_fixed_pallas(j_table, j_idx, j_w, interpret=True)
    assert got.dtype == dt and tuple(got.shape) == (s, d)
    gather_close(got, np.asarray(want.astype(jnp.float32)), dtype, k)
    assert not got[(t_idx < 0).all(1)].any()


@pytest.mark.parametrize("v,d,e,s,weighted,dtype", GATHER_SUM_CASES)
def test_segment_gather_sum_semantics(v, d, e, s, weighted, dtype):
    """The ragged form against the reference's plain version on every
    entry (negative and out-of-range ids and segments, empty segments), and
    against the TPU wrapper in interpret mode.  That wrapper's regrouped
    fast path masks a negative index as padding and folds a negative
    segment into segment S-1, where its own oracle (and the port) count a
    negative index from the end and drop the segment; so it is held on the
    entries with non-negative ids and segments, and on every entry when
    E > 32 * S, where it falls back to its oracle."""
    dt = getattr(torch, dtype)
    arrs = gather_sum_inputs(v, d, e, s, weighted, seed=v + e + s)
    (t_table, (t_idx, t_seg), t_w), (j_table, (j_idx, j_seg), j_w) = \
        _gather_args(arrs, dt)
    hot = -(-e // s)
    if dt == torch.bfloat16 and hot > 32:
        # the reference's segment_sum adds bfloat16 rows in bfloat16, which
        # drifts by up to 4% over runs of ~150; the port sums in float32,
        # so long runs are held against the reference computed in float32
        # on the same bfloat16 values
        j_table = j_table.astype(jnp.float32)
        j_w = None if j_w is None else j_w.astype(jnp.float32)
    got = ops.segment_gather_sum(t_table, t_idx, t_seg, s, weights=t_w)
    assert got.dtype == dt and tuple(got.shape) == (s, d)
    want = jref.segment_gather_sum_ref(j_table, j_idx, j_seg, s, weights=j_w)
    gather_close(got, np.asarray(want.astype(jnp.float32)), dtype, hot)
    sel = (arrs[1] >= 0) & (arrs[2] >= 0)
    if e > 32 * s:
        sel[:] = True
    sub = [tt(a[sel]) for a in arrs[1:3]]
    sub_w = None if t_w is None else t_w[torch.from_numpy(sel)]
    got = ops.segment_gather_sum(t_table, *sub, s, weights=sub_w)
    want = segment_gather_sum_pallas(
        j_table, jnp.asarray(arrs[1][sel]), jnp.asarray(arrs[2][sel]), s,
        weights=None if j_w is None else j_w[jnp.asarray(sel)],
        interpret=True)
    gather_close(got, np.asarray(want.astype(jnp.float32)), dtype, hot)


@pytest.mark.parametrize("v,d,e,s,kind,dtype,offset",
                         GATHER_RAGGED_EDGE_CASES)
def test_segment_gather_sum_edge_cases(v, d, e, s, kind, dtype, offset):
    """The ragged form's hard cases (negative ids, segments outside [0, S),
    empty segments, every entry dropped, E = 0, d of 1, 33, 64, 100 and
    300, a table view off its buffer's start) against the reference's
    oracle."""
    dt = getattr(torch, dtype)
    table, idx, seg, w = gather_ragged_edge_inputs(v, d, e, s, kind, e + d)
    flat = torch.zeros(table.size + offset, dtype=dt)
    flat[offset:] = torch.from_numpy(table).to(dt).reshape(-1)
    t_table = flat[offset:].view(table.shape)
    t_w = torch.from_numpy(w).to(dt)
    j_table = jnp.asarray(t_table.float().numpy())
    j_w = jnp.asarray(t_w.float().numpy())
    if dt == torch.bfloat16:
        # products in bfloat16 as the port takes them, summed in float32
        j_table, j_w = j_table.astype(jnp.bfloat16), j_w.astype(jnp.bfloat16)
    got = ops.segment_gather_sum(t_table, tt(idx), tt(seg), s, weights=t_w)
    assert got.dtype == dt and tuple(got.shape) == (s, d)
    want = jref.segment_gather_sum_ref(j_table.astype(jnp.float32)
                                       if dt == torch.float32 else j_table,
                                       jnp.asarray(idx), jnp.asarray(seg), s,
                                       weights=j_w)
    gather_close(got, np.asarray(want.astype(jnp.float32)), dtype,
                 max(1, -(-e // s)))
    if kind != "mixed":
        assert not got.float().any()


def test_segment_gather_sum_index_rules():
    """The rules on a 4-row table: -1 reads row 3, -6 row 0, 5 row 3;
    segments 7 and -1 are dropped."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = tt(np.array([0, 5, -1, -6, 2, 3], np.int32))
    seg = tt(np.array([0, 0, 1, 1, 7, -1], np.int32))
    got = ops.segment_gather_sum(table, idx, seg, 3)
    want = jref.segment_gather_sum_ref(jnp.asarray(table.numpy()),
                                       jnp.asarray(idx.numpy()),
                                       jnp.asarray(seg.numpy()), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), [[9, 11, 13], [9, 11, 13], [0, 0, 0]])


def test_cpu_calls_count_no_launches():
    ops.reset_launches()
    args, n_iters = edge_inputs(50, 20, 1)
    ops.edge_exists(*map(tt, args), n_iters=n_iters)
    bm, req = bitmap_inputs(10, 1, 2)
    ops.bitmap_superset(tt(bm), tt(req))
    assert all(v == 0 for v in ops.launches.values())
    assert set(ops.launches) == set(ops.KERNELS)


def test_mixed_devices_raise():
    bm, req = bitmap_inputs(10, 1, 2)
    with pytest.raises(ValueError):
        ops.bitmap_superset(tt(bm), torch.empty(1, dtype=torch.int32,
                                                device="meta"))
