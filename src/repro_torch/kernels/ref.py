"""Plain PyTorch versions of every kernel entry point.

These are the same functions as the reference's ``repro.kernels.ref``, on
torch tensors.  The CPU path runs them (``ops`` dispatches a CPU tensor
here), and the card's hand-written kernels are held against them.

Bitmaps, masks and signatures are int32 tensors holding the uint32 words'
bit patterns: ``&`` and ``==`` on them are bit-identical to the unsigned
versions.  Every gather clamps its index where the reference clamps, since
torch raises on an out-of-range index where JAX clamps silently.
"""

from __future__ import annotations

import torch


def _midpoint(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``floor((lo + hi) / 2)`` without forming ``lo + hi``, which wraps in
    int32 once it passes 2^31 - 1 (any range past offset 2^30 of a
    billion-word adjacency); equal to ``(lo + hi) >> 1`` wherever that does
    not wrap."""
    return lo + ((hi - lo) >> 1)


def edge_exists_ref(nbr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    target: torch.Tensor, n_iters: int = 32) -> torch.Tensor:
    """Batched lower-bound binary search: ``target ∈ nbr[lo:hi)``, bool [B]
    (the paper's IsJoinable probe, ``n_iters`` halving rounds)."""
    m = max(1, nbr.shape[0])
    lo0 = lo.to(torch.int32)
    hi0 = hi.to(torch.int32)
    lo_, hi_ = lo0, hi0
    for _ in range(n_iters):
        mid = _midpoint(lo_, hi_)
        go_right = nbr[mid.clamp(0, m - 1)] < target
        lo_, hi_ = torch.where(go_right, mid + 1, lo_), \
            torch.where(go_right, hi_, mid)
    found = (lo_ < hi0) & (nbr[lo_.clamp(0, m - 1)] == target)
    return found & (lo0 < hi0)


def tile_membership_ref(a: torch.Tensor, b: torch.Tensor,
                        iptr: torch.Tensor | None = None,
                        probe: torch.Tensor | None = None,
                        tb: int | None = None) -> torch.Tensor:
    """Per-row compare-all membership ``out[i, j] = a[i, j] ∈ b[i, :]``;
    negative entries of ``a`` (padding) never match.

    The range form (``iptr``, ``probe``, ``tb``): ``b`` is the flat
    adjacency ``nbr`` and ``a`` the candidates ``v`` [R]; row i's tile is
    built as the executor builds its ``adj_tile`` (``p = clamp(probe[i], 0,
    n-1)`` with ``n = len(iptr) - 1``, positions ``iptr[p] + j`` for ``j <
    tb`` below ``iptr[p + 1]``, each read at ``clamp(pos, 0, M-1)``, the
    rest ``-2``), then tested; bool [R].  An empty ``nbr`` holds
    nothing."""
    if iptr is None:
        eq = a[:, :, None] == b[:, None, :]
        return torch.any(eq & (a[:, :, None] >= 0), dim=-1)
    if b.shape[0] == 0:
        return torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    psafe = probe.clamp(0, iptr.shape[0] - 2).long()
    lo = iptr[psafe]
    hi = iptr[psafe + 1]
    pos = lo[:, None] + torch.arange(tb, dtype=lo.dtype,
                                     device=lo.device)[None, :]
    tile = torch.where(pos < hi[:, None],
                       b[pos.clamp(0, b.shape[0] - 1).long()], -2)
    return tile_membership_ref(a[:, None], tile)[:, 0]


def bitmap_superset_ref(bitmap: torch.Tensor, required: torch.Tensor,
                        ids: torch.Tensor | None = None) -> torch.Tensor:
    """Row-wise ``(bitmap & required) == required`` over all words, bool
    [B]; with ``ids`` the rows ``bitmap[clamp(ids, 0, V-1)]``, bool
    [len(ids)]."""
    rows = bitmap if ids is None else bitmap[_clamp_rows(bitmap, ids)]
    req = required[None, :]
    return torch.all((rows & req) == req, dim=-1)


def signature_filter_ref(sig: torch.Tensor, v: torch.Tensor,
                         required: torch.Tensor) -> torch.Tensor:
    """Gather ``sig[clamp(v)]`` rows, then the superset test, bool [B]."""
    return bitmap_superset_ref(sig, required, ids=v)


def _clamp_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``idx`` clamped into ``[0, V-1]`` as int64 (a gather clamps where JAX
    does)."""
    return idx.long().clamp(0, max(1, table.shape[0]) - 1)


def segment_gather_fixed_ref(table: torch.Tensor, idx: torch.Tensor,
                             weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Fused gather + weighted sum over the fixed-hotness layout:
    ``out[s] = Σ_k w[s, k] · table[idx[s, k]]`` for ``idx int32 [S, K]``.
    An index ``< 0`` is padding and adds nothing; an index ``≥ V`` reads
    row ``V-1``.  Weights (default 1) are cast to the table's dtype and each
    product is taken in that dtype, as the TPU kernel takes them; the sum
    runs in float32 in entry order (``k = 0, 1, ...``, as the CUDA kernel
    adds, so an unweighted float32 bag is bit-equal to it) and is written
    in the table's dtype."""
    rows = table[_clamp_rows(table, idx)]  # [S, K, D]
    if weights is not None:
        rows = rows * weights.to(table.dtype)[:, :, None]
    rows = torch.where((idx >= 0)[:, :, None], rows, 0).float()
    acc = torch.zeros((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(idx.shape[1]):
        acc = acc + rows[:, k]
    return acc.to(table.dtype)


def segment_gather_sum_ref(table: torch.Tensor, indices: torch.Tensor,
                           segments: torch.Tensor, num_segments: int,
                           weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Fused gather + segment-sum (EmbeddingBag-sum / GNN aggregate):
    ``out[s] = Σ_{e: segments[e] = s} w[e] · table[indices[e]]``.

    The reference's semantics (``table[indices]`` then
    ``jax.ops.segment_sum``): a negative index counts from the end, as in
    numpy, and the result is then clamped into ``[0, V-1]`` (``-1`` reads
    row ``V-1``, ``-6`` on a 4-row table row 0, ``V`` row ``V-1``); an
    entry whose segment lies outside ``[0, num_segments)`` is dropped.
    Weights are cast to the table's dtype and products taken in it; the
    sum runs in float32 and is written in the table's dtype."""
    v = table.shape[0]
    idx = indices.long()
    rows = table[_clamp_rows(table, torch.where(idx < 0, idx + v, idx))]
    if weights is not None:
        rows = rows * weights.to(table.dtype)[:, None]
    seg = segments.long()
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments,) + tuple(table.shape[1:]),
                      dtype=torch.float32, device=table.device)
    out.index_add_(0, seg[keep], rows[keep].float())
    return out.to(table.dtype)


def expand_filter_compact_ref(nbr: torch.Tensor, bitmap: torch.Tensor,
                              start: torch.Tensor, deg: torch.Tensor,
                              offs: torch.Tensor, label_mask: torch.Tensor,
                              bound_id: torch.Tensor, capacity: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Fused ragged CSR expansion + bitmap superset filter + compaction.

    The candidate stream is the concatenation over rows i of
    ``nbr[start[i] : start[i] + deg[i]]``; a candidate v survives iff
    ``(bitmap[v] & label_mask) == label_mask`` and, when the bound id
    ``bid`` (a one-element int32 tensor: a step's baked scalar or
    ``params[slot]`` of a parameterized plan) is ``>= 0``, ``v == bid``.  Only the first ``capacity`` slots take part.
    Survivors are compacted to a prefix in stream order.  Returns
    ``(v_out, row_out, count)``: int32 [capacity] each, -1 past ``count``,
    and ``count`` an int32 scalar tensor.
    """
    row, j, valid = ragged_expand_ref(offs, deg, capacity)
    idx = (start[row] + j).clamp(0, max(1, nbr.shape[0]) - 1)
    v = torch.where(valid, nbr[idx], -1)
    vsafe = v.clamp(0, bitmap.shape[0] - 1)
    bid = bound_id.reshape(())
    ok = valid & bitmap_superset_ref(bitmap[vsafe], label_mask) \
        & ((bid < 0) | (v == bid))
    oki = ok.to(torch.int32)
    pos = torch.where(ok, torch.cumsum(oki, 0, dtype=torch.int32) - 1,
                      capacity).long()
    v_out = torch.full((capacity + 1,), -1, dtype=torch.int32,
                       device=nbr.device)
    row_out = torch.full_like(v_out, -1)
    v_out[pos] = v
    row_out[pos] = row
    return v_out[:capacity], row_out[:capacity], oki.sum(dtype=torch.int32)


def delta_merge_ref(base_nbr, delta_nbr, tomb_nbr, b_start, b_deg, d_start,
                    t_lo, t_hi, j, valid, n_iters: int = 32, row=None):
    """Merged base+delta slot resolution with tombstone masking: position
    ``j < b_deg`` reads the base slice, later positions the delta slice;
    base candidates found in ``tomb_nbr[t_lo:t_hi)`` are masked.  Returns
    ``(v, ok)``.  The five fields are per slot, or, with ``row``, per row:
    slot ``i`` reads ``field[clamp(row[i], 0, R-1)]``.  ``d_start``,
    ``t_lo`` and ``t_hi`` may be ``None`` and then read as 0."""
    fields = (b_start, b_deg, d_start, t_lo, t_hi)
    if row is not None:
        r = _clamp_rows(b_start, row)
        fields = tuple(None if f is None else f[r] for f in fields)
    zero = torch.zeros_like(j)
    b_start, b_deg, d_start, t_lo, t_hi = (zero if f is None else f
                                           for f in fields)
    is_base = j < b_deg
    mb = max(1, base_nbr.shape[0])
    md = max(1, delta_nbr.shape[0])
    v_b = base_nbr[(b_start + j).clamp(0, mb - 1)]
    v_d = delta_nbr[(d_start + (j - b_deg)).clamp(0, md - 1)]
    v = torch.where(is_base, v_b, v_d)
    dead = is_base & edge_exists_ref(tomb_nbr, t_lo, t_hi, v, n_iters=n_iters)
    return torch.where(valid, v, -1), valid & ~dead


def delta_merge_labeled_ref(base_nbr, base_lab, delta_nbr, delta_lab,
                            tomb_key, b_start, b_deg, d_start, t_lo, t_hi, j,
                            valid, n_elabels: int, n_iters: int = 32):
    """Predicate-variable variant of :func:`delta_merge_ref`: candidates
    carry their edge label, and tombstones match the composite key
    ``nbr * n_elabels + el``.  Returns ``(v, el, ok)``."""
    is_base = j < b_deg
    mb = max(1, base_nbr.shape[0])
    md = max(1, delta_nbr.shape[0])
    ib = (b_start + j).clamp(0, mb - 1)
    idlt = (d_start + (j - b_deg)).clamp(0, md - 1)
    v = torch.where(is_base, base_nbr[ib], delta_nbr[idlt])
    el = torch.where(is_base, base_lab[ib], delta_lab[idlt])
    key = v * n_elabels + el
    dead = is_base & edge_exists_ref(tomb_key, t_lo, t_hi, key,
                                     n_iters=n_iters)
    ok = valid & ~dead
    return torch.where(valid, v, -1), torch.where(valid, el, -1), ok


def ragged_expand_ref(offsets: torch.Tensor, degrees: torch.Tensor,
                      capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten ragged per-row ranges into ``capacity`` output slots: slot k
    belongs to row ``row[k]`` at within-row position ``j[k]``; slots past
    the total are invalid.  Returns int32 ``row``, ``j`` and bool
    ``valid``."""
    total = degrees.sum()
    k = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    row = torch.searchsorted(offsets.to(torch.int32), k, right=True)
    row = (row.to(torch.int32) - 1).clamp(0, max(1, offsets.shape[0]) - 1)
    j = k - offsets[row]
    valid = (k < total) & (j < degrees[row]) & (j >= 0)
    return row, j.to(torch.int32), valid
