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
from torch_cases import (DELTA_CASES, EFC_CASES, bitmap_inputs,  # noqa: E402
                         delta_inputs, edge_inputs, efc_inputs, same,
                         sig_inputs, tile_inputs, tt)


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
    got = ops.expand_filter_compact(*map(tt, args), bid, cap)
    for g_, w_, p_ in zip(got, want, pallas):
        same(g_, w_)
        same(g_, p_)
    if cap < total:
        assert int(got[2]) <= cap


def test_expand_filter_compact_bound_filters_everything_else():
    args, bid, _ = efc_inputs(30, 12, 1, 5, with_mask=False)
    v_out, row_out, count = ops.expand_filter_compact(*map(tt, args), bid, 256)
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
