"""Seeded kernel inputs and comparisons shared by the port's kernel tests
(``test_torch_kernels.py`` against the reference on the CPU,
``test_torch_cuda.py`` against the plain versions on the card).  Imports
torch and numpy only."""

import numpy as np
import torch


def tt(a: np.ndarray, device="cpu") -> "torch.Tensor":
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def same(got, want) -> None:
    """Bit-equality; torch int32 bitmaps compare as uint32 words."""
    got, want = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in (got, want))
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert got.shape == want.shape


def edge_inputs(m, b, seed):
    rng = np.random.default_rng(seed)
    nbr = np.sort(rng.integers(0, 500, size=m)).astype(np.int32)
    lo = rng.integers(0, m, size=b).astype(np.int32)
    hi = np.minimum(m, lo + rng.integers(0, 50, size=b)).astype(np.int32)
    hi[::7] = lo[::7]  # empty slices
    hit = rng.random(b) < 0.5
    tgt = np.where(hit & (hi > lo), nbr[np.minimum(lo, m - 1)],
                   rng.integers(-1, 520, size=b)).astype(np.int32)
    n_iters = max(2, int(np.ceil(np.log2(max(2, int((hi - lo).max()))))) + 1)
    return (nbr, lo, hi, tgt), n_iters


def tile_inputs(r, ta, tb, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 40, size=(r, ta)).astype(np.int32)
    b = rng.integers(-1, 40, size=(r, tb)).astype(np.int32)
    b = np.where(b < 0, -2, b).astype(np.int32)  # adjacency tile padding
    return a, b


# tile_membership's range form: (rows, n, max_deg, tb).  Degrees run from 0
# to max_deg (every fifth row 0, row 1 exactly max_deg), probes lie in
# [-3, n + 3) so some clamp, and some candidates are negative.  Cases: each
# tb of the executor (8 to 128) with degrees up to tb; degrees past tb
# (the tile cuts the range at lo + tb); tb that is no power of two or
# needs more than 4 words a lane; one row; a main-path size.
TILE_RANGE_CASES = [
    (1, 1, 0, 8),
    (7, 3, 8, 8),
    (1000, 300, 8, 8),
    (1000, 300, 16, 16),
    (1000, 300, 32, 32),
    (1000, 300, 64, 64),
    (1000, 300, 128, 128),
    (500, 100, 40, 16),
    (300, 50, 12, 12),
    (300, 50, 200, 256),
    (33_000, 5000, 32, 32),
]


def tile_range_inputs(rows, n, max_deg, tb, seed):
    """``(nbr, iptr, table, v)`` for the range form: a CSR of ``n`` rows
    (each row's ids sorted, three words of padding past its end), a
    ``[rows, 3]`` binding table whose column 1 is the probe (a strided
    view), and candidates ``v``: half drawn from the probe's adjacency
    (hits, some past ``lo + tb``), the rest random or negative."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, size=n)
    deg[::5] = 0
    if n > 1:
        deg[1] = max_deg
    iptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nbr = np.concatenate(
        [np.sort(rng.integers(0, 400, size=int(d))) for d in deg]
        + [rng.integers(0, 400, size=3)]).astype(np.int32)
    table = rng.integers(-1, 400, size=(rows, 3)).astype(np.int32)
    probe = rng.integers(-3, n + 3, size=rows)
    table[:, 1] = probe
    p = np.clip(probe, 0, n - 1)
    lo, hi = iptr[p], iptr[p + 1]
    pick = lo + rng.integers(0, np.maximum(hi - lo, 1))
    v = np.where((rng.random(rows) < 0.5) & (hi > lo), nbr[pick],
                 rng.integers(-40, 400, size=rows)).astype(np.int32)
    return nbr, iptr, table, v


def tile_range_tile(nbr, iptr, probe, tb):
    """The executor's ``adj_tile`` for the range form (numpy, as
    ``repro/core/exec.py`` builds it): ``int32 [rows, tb]``, ``-2`` past
    each row's range."""
    p = np.clip(probe, 0, iptr.shape[0] - 2)
    lo, hi = iptr[p], iptr[p + 1]
    pos = lo[:, None] + np.arange(tb, dtype=np.int32)[None, :]
    return np.where(pos < hi[:, None],
                    nbr[np.clip(pos, 0, nbr.shape[0] - 1)], -2).astype(
                        np.int32)


def bitmap_inputs(b, w, seed):
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2**32, size=(b, w), dtype=np.uint64).astype(np.uint32)
    req = np.zeros(w, np.uint32)
    req[0] = np.uint32(0x80000001)  # high bit: the int32 pattern is negative
    if w > 1:
        req[-1] = np.uint32(0x00F0F000)
    bm[::3] |= req  # a third certainly pass
    return bm, req


def sig_inputs(v, w2, b, seed):
    rng = np.random.default_rng(seed)
    sig = rng.integers(0, 2**32, size=(v, w2), dtype=np.uint64).astype(np.uint32)
    req = (sig[0] & np.uint32(0x90010003)).astype(np.uint32)
    ids = rng.integers(-3, v + 3, size=b).astype(np.int32)  # out of range clamps
    return sig, ids, req


def efc_inputs(r, v, w, seed, with_mask=True, bound=None, empty_every=3):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, size=r).astype(np.int32)
    deg[::empty_every] = 0  # empty rows
    m = max(1, int(deg.sum()) + 5)
    nbr = rng.integers(0, v, size=m).astype(np.int32)
    start = np.zeros(r, np.int32)
    pos = 0
    for i in range(r):
        start[i] = pos
        pos += int(deg[i])
    offs = (np.cumsum(deg) - deg).astype(np.int32)
    bitmap = rng.integers(0, 2**32, size=(v, w), dtype=np.uint64).astype(np.uint32)
    mask = np.zeros(w, np.uint32)
    if with_mask:
        mask[0] = np.uint32(0x5)
        mask[-1] |= np.uint32(0x80000000)
    bid = int(nbr[rng.integers(m)]) if bound is None else bound
    return (nbr, bitmap, start, deg, offs, mask), bid, int(deg.sum())


EFC_CASES = [
    # r, v, w, capacity, with_mask, bound: None = a present id, -1 = none
    (1, 4, 1, 8, True, -1),
    (10, 16, 1, 64, True, -1),
    (10, 16, 2, 64, False, None),
    (40, 64, 5, 256, True, -1),
    (40, 64, 2, 16, True, -1),  # total > capacity
    (64, 32, 1, 512, True, None),
    (33, 20, 5, 128, False, -1),
]


# expand_filter_compact cases that stress the one-launch kernel's look-back,
# its row windows and its -1 tail: (kind, capacity).  On the card a tile is
# 128 slots below capacity 2^15, 256 below 2^16, 512 below 2^17 and 1024
# from there on.
EFC_EDGE_CASES = [
    ("all_survive", 1 << 22),     # 4096 tiles, every slot survives, no tail
    ("none_survive", 1 << 16),    # count 0: every slot -1
    ("last_tile_only", 1 << 15),  # survivors only in the last tile
    ("last_tile_only", 1 << 20),
    ("total_minus_1", 1 << 16),
    ("total_plus_1", 1 << 16),
    ("total_minus_1", 5000),      # a partial last tile
    ("total_plus_1", 5000),
    ("zero_runs", 1 << 14),       # windows wider than the staged 2048 rows
    ("zero_gaps", 1 << 14),       # zero-degree rows inside staged windows
    ("bound_one", 1 << 16),       # the bound id matches exactly one slot
]


def efc_edge_inputs(kind, cap, seed=0):
    """``((nbr, bitmap, start, deg, offs, mask), bound id)`` for one case of
    ``EFC_EDGE_CASES``.  Rows are laid out back to back (``start == offs``),
    so slot k < total reads ``nbr[k]``."""
    rng = np.random.default_rng(seed)
    n_v, w = 1000, 2
    mask = np.array([0x5, 0x80000000], np.uint32)
    bitmap = rng.integers(0, 2**32, size=(n_v, w),
                          dtype=np.uint64).astype(np.uint32)
    bid = -1
    total = cap
    if kind == "all_survive":
        deg = np.full(cap // 4, 4, np.int32)
        mask[:] = 0
    elif kind in ("zero_runs", "zero_gaps"):
        # a row has edges with probability 1/300 (runs of thousands of
        # empty rows) or 1/8
        p = 1 / 300 if kind == "zero_runs" else 1 / 8
        n_rows = int(cap / 4.5 / p * 1.2)
        deg = np.where(rng.random(n_rows) < p,
                       rng.integers(1, 9, n_rows), 0).astype(np.int32)
        deg[0] = 0
        total = None
    else:
        total = {"total_minus_1": cap - 1, "total_plus_1": cap + 1}.get(
            kind, cap + cap // 3)
        deg = rng.integers(0, 9, size=total).astype(np.int32)
        deg = deg[:int(np.searchsorted(np.cumsum(deg), total)) + 1]
        deg[-1] -= int(deg.sum()) - total
    m = int(deg.sum()) + 5
    nbr = rng.integers(1, n_v, size=m).astype(np.int32)
    if kind == "none_survive":
        bitmap &= ~mask
    elif kind == "last_tile_only":
        bitmap[1:] &= ~mask
        bitmap[0] |= mask
        nbr[cap - 3:cap] = 0
    elif kind == "bound_one":
        n_v = m
        nbr = rng.permutation(m).astype(np.int32)
        bitmap = np.full((n_v, w), 0xFFFFFFFF, np.uint32)
        bid = int(nbr[rng.integers(min(cap, m - 5))])
    offs = (np.cumsum(deg) - deg).astype(np.int32)
    assert total is None or int(deg.sum()) == total
    return (nbr, bitmap, offs.copy(), deg, offs, mask), bid


# input sets (r, v, w, bound) of the back-to-back and two-stream calls: a
# large stream (about 800K slots), a small one with a bound id present, and
# one row; and the capacities of 50 back-to-back calls
EFC_STREAM_SETS = ((300_000, 5000, 2, -1), (500, 64, 1, None), (1, 4, 3, -1))
EFC_BACK_TO_BACK_CAPS = np.random.default_rng(7).choice(
    [1, 3, 64, 255, 256, 257, 1000, 5000, 1 << 14, 1 << 15, 40_000, 1 << 16,
     1 << 18, 1 << 20, 1 << 22], size=50).tolist()


def efc_tickets_settled(ops) -> bool:
    """Between calls, each look-back buffer's ticket word (the last word:
    32 bits of tickets under the call epoch) has handed out no ticket of a
    new call, and its epoch counts the calls made on the buffer."""
    return all(int(buf[-1]) == calls << 32
               for buf, calls in ops._EFC_SCRATCH.values())


# signature_filter edge cases: (n, w2) for n of 1 to 9 ids, each run on a
# 16-byte-aligned v and on a v[1:] view
SIG_EDGE_CASES = [(n, w2) for w2 in (2, 4, 10) for n in range(1, 10)]


# bitmap_superset with row ids: (n, w) for n of 1 to 9 ids and a large n,
# each run on a 16-byte-aligned ids and on an ids[1:] view
BITMAP_EDGE_CASES = [(n, w) for w in (1, 2, 3, 5, 9)
                     for n in (*range(1, 10), 5000)]


def bitmap_ids_inputs(v, w, n, seed):
    """``(bitmap [v, w], required, ids [n])`` for the ids form: ids in
    ``[-3, v + 3)``, so negative and out-of-range ids clamp; a third of the
    rows certainly pass."""
    bm, req = bitmap_inputs(v, w, seed)
    ids = np.random.default_rng(seed + 1).integers(-3, v + 3, size=n)
    return bm, req, ids.astype(np.int32)


# delta_merge with row ids: (k, rows, mb, md, mt, run, absent, none_valid).
# ``absent`` names the row-level fields passed as None (read as 0);
# ``none_valid`` makes every slot invalid.  k % 4 != 0 leaves slots outside
# the kernel's groups of 4; runs > 256 need more than 8 search rounds; the
# last case's base array passes 2^20 words (the TPU kernel falls back to its
# oracle there).
DELTA_ROW_CASES = [
    (1, 1, 10, 4, 4, 4, (), False),
    (203, 40, 300, 50, 40, 4, (), False),
    (256, 60, 300, 50, 40, 4, ("d_start",), False),
    (256, 60, 300, 50, 40, 4, ("t_lo",), False),
    (256, 60, 300, 50, 40, 4, ("t_hi",), False),
    (258, 60, 300, 0, 0, 4, ("d_start", "t_lo", "t_hi"), False),
    (130, 30, 300, 50, 40, 4, (), True),
    (1001, 50, 4000, 64, 3000, 1500, (), False),
    (4099, 300, (1 << 20) + 5000, 1000, 2000, 40, (), False),
]
DELTA_FIELDS = ("b_start", "b_deg", "d_start", "t_lo", "t_hi")


def delta_row_inputs(k, r, mb, md, mt, run, seed, none_valid=False):
    """Seeded row-form ``delta_merge`` inputs: ``(arrays, fields, row, j,
    valid, n_iters)`` with ``arrays = (base, delta, tomb)`` (tombstones
    drawn from the base values), ``fields`` the five row-level arrays of
    ``r`` rows, ``row`` nondecreasing as ragged expansion makes it with a
    few ids outside ``[0, r)`` (they clamp), and an invalid tail."""
    rng = np.random.default_rng(seed)
    vmax = max(60, mb // 2)
    base = np.sort(rng.integers(0, vmax, size=mb)).astype(np.int32)
    delta = rng.integers(0, vmax, size=md).astype(np.int32)
    tomb = np.sort(base[rng.integers(0, max(mb, 1), size=mt)]
                   if mb else np.zeros(mt, np.int32)).astype(np.int32)
    t_lo = rng.integers(0, max(mt, 1), size=r)
    fields = (rng.integers(0, max(mb, 1), size=r), rng.integers(0, 6, size=r),
              rng.integers(0, max(md, 1), size=r), t_lo,
              np.minimum(mt, t_lo + rng.integers(0, run, size=r)))
    row = np.sort(rng.integers(0, r, size=k))
    out = rng.random(k) < 0.05
    row[out] = rng.choice([-2, r, r + 5], size=int(out.sum()))
    j = rng.integers(0, 9, size=k)
    valid = rng.random(k) < 0.9
    valid[k - k // 5:] = False
    if none_valid:
        valid[:] = False
    n_iters = 32 if run > 64 else 8
    return ((base, delta, tomb), tuple(f.astype(np.int32) for f in fields),
            row.astype(np.int32), j.astype(np.int32), valid, n_iters)


def delta_inputs(k, mb, md, mt, seed, labeled=False, run=4, vmax=60,
                 mode="mixed"):
    """Seeded ``delta_merge`` inputs: a sorted base array, a delta array, a
    sorted tombstone array drawn from the base values (so tombstones hit),
    per-slot row fields and slot positions.  ``run`` bounds each slot's
    tombstone run; ``mode`` is ``"mixed"`` (base and delta slots),
    ``"base"`` (every slot reads the base) or ``"delta"`` (every slot reads
    the delta).  Zero-length arrays are allowed."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.integers(0, vmax, size=mb)).astype(np.int32)
    delta = rng.integers(0, vmax, size=md).astype(np.int32)
    b_start = rng.integers(0, max(mb, 1), size=k).astype(np.int32)
    b_deg = rng.integers(0, 6, size=k).astype(np.int32)
    d_start = rng.integers(0, max(md, 1), size=k).astype(np.int32)
    t_lo = rng.integers(0, max(mt, 1), size=k).astype(np.int32)
    t_hi = np.minimum(mt, t_lo + rng.integers(0, run, size=k)).astype(np.int32)
    j = rng.integers(0, 9, size=k).astype(np.int32)
    valid = rng.random(k) < 0.8
    if mode == "base":
        b_deg = np.maximum(b_deg, 1)
        j = (j % b_deg).astype(np.int32)
    elif mode == "delta":
        j = (b_deg + j).astype(np.int32)
    pick = rng.integers(0, max(mb, 1), size=mt)
    if labeled:
        n_el = 5
        base_lab = rng.integers(0, n_el, size=mb).astype(np.int32)
        delta_lab = rng.integers(0, n_el, size=md).astype(np.int32)
        tomb = np.sort(base[pick].astype(np.int64) * n_el
                       + base_lab[rng.integers(0, mb, size=mt)]
                       ).astype(np.int32)
        return (base, base_lab, delta, delta_lab, tomb, b_start, b_deg,
                d_start, t_lo, t_hi, j, valid), n_el
    tomb = np.sort(base[pick] if mb else np.zeros(mt, np.int32)) \
        .astype(np.int32)
    return (base, delta, tomb, b_start, b_deg, d_start, t_lo, t_hi, j,
            valid), None


DELTA_CASES = [
    # k, mb, md, mt, run, mode
    (200, 300, 0, 40, 4, "mixed"),      # empty delta array
    (200, 300, 50, 0, 4, "mixed"),      # empty tombstone array
    (200, 0, 50, 0, 4, "delta"),        # empty base array, all-delta rows
    (300, 200, 50, 30, 4, "delta"),     # all-delta rows
    (300, 200, 50, 30, 4, "base"),      # all-base rows, tombstone hits
    (500, 4000, 64, 3000, 1500, "mixed"),  # tombstone runs longer than 256
]


# segment_gather: (v, d, s, k, weighted, dtype) for the fixed layout and
# (v, d, e, s, weighted, dtype) for the ragged form; E > 32 * S in the last
# ragged cases (the TPU wrapper falls back to its oracle there)
GATHER_FIXED_CASES = [
    (1, 1, 1, 1, False, "float32"),
    (40, 16, 30, 8, False, "float32"),
    (40, 64, 33, 8, True, "float32"),
    (300, 100, 50, 32, True, "float32"),
    (300, 200, 20, 5, True, "float32"),  # two feature tiles
    (40, 64, 33, 8, False, "bfloat16"),
    (300, 100, 50, 32, True, "bfloat16"),
]
GATHER_SUM_CASES = [
    (4, 3, 6, 3, False, "float32"),
    (50, 16, 300, 40, True, "float32"),
    (200, 64, 1000, 120, True, "float32"),
    (200, 100, 1000, 120, False, "bfloat16"),
    (200, 64, 1000, 120, True, "bfloat16"),
    (60, 100, 3000, 20, True, "float32"),  # runs of ~150
    (60, 64, 3000, 20, True, "bfloat16"),
]


# the ragged form's hard cases: (v, d, e, s, kind, dtype, offset).  kind:
# "mixed" (negative indices, segments outside [0, s), empty segments),
# "dropped" (every segment outside [0, s)), "empty" (E = 0); offset > 0
# puts the table at an unaligned base (4-byte columns); d = 100 (float32)
# and 64 (both dtypes) take 16-byte rows where aligned, d = 1 and 33 not.
GATHER_RAGGED_EDGE_CASES = [
    (30, 1, 500, 40, "mixed", "float32", 0),
    (30, 33, 500, 40, "mixed", "float32", 0),
    (30, 100, 500, 40, "mixed", "float32", 0),
    (30, 100, 500, 40, "mixed", "float32", 1),
    (30, 64, 500, 40, "mixed", "bfloat16", 0),
    (30, 100, 500, 40, "mixed", "bfloat16", 0),
    (30, 64, 500, 40, "mixed", "bfloat16", 3),
    (30, 100, 300, 20, "dropped", "float32", 0),
    (30, 100, 0, 20, "empty", "float32", 0),
    (30, 300, 2000, 50, "mixed", "float32", 0),
]


def gather_ragged_edge_inputs(v, d, e, s, kind, seed):
    """``(table, indices, segments, weights)`` of one
    ``GATHER_RAGGED_EDGE_CASES`` case (weights on every case)."""
    table, idx, seg, w = gather_sum_inputs(v, d, e, s, True, seed)
    if kind == "dropped":
        seg = np.where(np.arange(e) % 2 == 0, -1 - np.abs(seg),
                       s + np.abs(seg)).astype(np.int32)
    return table, idx, seg, w


def gather_fixed_inputs(v, d, s, k, weighted, seed):
    """``(table, idx [S, K], weights)``: ids in ``[-3, v + 3)`` (negative =
    padding, ``>= v`` clamps), every third row all padding."""
    rng = np.random.default_rng(seed)
    table = rng.random((v, d), dtype=np.float32)
    idx = rng.integers(-3, v + 3, size=(s, k)).astype(np.int32)
    idx[::3] = -1
    w = rng.random((s, k), dtype=np.float32) + 0.5 if weighted else None
    return table, idx, w


def gather_sum_inputs(v, d, e, s, weighted, seed):
    """``(table, indices, segments, weights)``: ids in ``[-v - 3, v + 3)``,
    segments in ``[-2, s + 2)`` with every fourth segment left empty."""
    rng = np.random.default_rng(seed)
    table = rng.random((v, d), dtype=np.float32)
    idx = rng.integers(-v - 3, v + 3, size=e).astype(np.int32)
    seg = rng.integers(-2, s + 2, size=e).astype(np.int32)
    seg[(seg >= 0) & (seg % 4 == 1)] = s + 1
    w = rng.random(e, dtype=np.float32) + 0.5 if weighted else None
    return table, idx, seg, w


def gather_close(got, want, dtype: str, hot: int) -> None:
    """The stated tolerances of ``segment_gather``, whose sums run in
    another order (and, for bfloat16, another precision) than the
    reference's: float32 ``rtol=atol=1e-5`` for runs of at most 32 entries
    and ``1e-4`` for longer runs; bfloat16 ``rtol=2e-2`` (about 5 of its 8
    mantissa bits), ``atol=2e-2``."""
    got = got.float().cpu().numpy()
    if dtype == "bfloat16":
        tol = 2e-2
    else:
        tol = 1e-5 if hot <= 32 else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
