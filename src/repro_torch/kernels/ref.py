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


def edge_exists_ref(nbr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    target: torch.Tensor, n_iters: int = 32) -> torch.Tensor:
    """Batched lower-bound binary search: ``target ∈ nbr[lo:hi)``, bool [B]
    (the paper's IsJoinable probe, ``n_iters`` halving rounds)."""
    m = max(1, nbr.shape[0])
    lo0 = lo.to(torch.int32)
    hi0 = hi.to(torch.int32)
    lo_, hi_ = lo0, hi0
    for _ in range(n_iters):
        mid = (lo_ + hi_) >> 1
        go_right = nbr[mid.clamp(0, m - 1)] < target
        lo_, hi_ = torch.where(go_right, mid + 1, lo_), \
            torch.where(go_right, hi_, mid)
    found = (lo_ < hi0) & (nbr[lo_.clamp(0, m - 1)] == target)
    return found & (lo0 < hi0)


def tile_membership_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row compare-all membership ``out[i, j] = a[i, j] ∈ b[i, :]``;
    negative entries of ``a`` (padding) never match."""
    eq = a[:, :, None] == b[:, None, :]
    return torch.any(eq & (a[:, :, None] >= 0), dim=-1)


def bitmap_superset_ref(bitmap: torch.Tensor,
                        required: torch.Tensor) -> torch.Tensor:
    """Row-wise ``(bitmap & required) == required`` over all words, bool [B]."""
    req = required[None, :]
    return torch.all((bitmap & req) == req, dim=-1)


def signature_filter_ref(sig: torch.Tensor, v: torch.Tensor,
                         required: torch.Tensor) -> torch.Tensor:
    """Gather ``sig[clamp(v)]`` rows, then the superset test, bool [B]."""
    rows = sig[v.clamp(0, sig.shape[0] - 1)]
    req = required[None, :]
    return torch.all((rows & req) == req, dim=-1)


def segment_gather_sum_ref(table: torch.Tensor, indices: torch.Tensor,
                           segments: torch.Tensor, num_segments: int,
                           weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Fused gather + segment-sum (EmbeddingBag-sum / GNN aggregate)."""
    rows = table[indices]
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros((num_segments,) + tuple(table.shape[1:]),
                      dtype=rows.dtype, device=table.device)
    return out.index_add_(0, segments.long(), rows)


def expand_filter_compact_ref(nbr: torch.Tensor, bitmap: torch.Tensor,
                              start: torch.Tensor, deg: torch.Tensor,
                              offs: torch.Tensor, label_mask: torch.Tensor,
                              bound_id: int, capacity: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Fused ragged CSR expansion + bitmap superset filter + compaction.

    The candidate stream is the concatenation over rows i of
    ``nbr[start[i] : start[i] + deg[i]]``; a candidate v survives iff
    ``(bitmap[v] & label_mask) == label_mask`` and, when ``bound_id >= 0``,
    ``v == bound_id``.  Only the first ``capacity`` slots take part.
    Survivors are compacted to a prefix in stream order.  Returns
    ``(v_out, row_out, count)``: int32 [capacity] each, -1 past ``count``,
    and ``count`` an int32 scalar tensor.
    """
    row, j, valid = ragged_expand_ref(offs, deg, capacity)
    idx = (start[row] + j).clamp(0, max(1, nbr.shape[0]) - 1)
    v = torch.where(valid, nbr[idx], -1)
    vsafe = v.clamp(0, bitmap.shape[0] - 1)
    ok = valid & bitmap_superset_ref(bitmap[vsafe], label_mask)
    if bound_id >= 0:
        ok &= v == bound_id
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
                    t_lo, t_hi, j, valid, n_iters: int = 32):
    """Merged base+delta slot resolution with tombstone masking: position
    ``j < b_deg`` reads the base slice, later positions the delta slice;
    base candidates found in ``tomb_nbr[t_lo:t_hi)`` are masked.  Returns
    ``(v, ok)``."""
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
