"""Kernel dispatch by device.

A CPU tensor goes to the plain PyTorch version in :mod:`ref`; a CUDA
tensor goes to the hand-written Hopper kernel, or the call raises.  Nothing
else picks the path: no environment switch, no fallback.  Each kernel
wrapper adds one to ``launches[name]`` where it launches its kernel and
nowhere else, so a run can show which kernels it went through.

The five kernels replace the reference's on-path Pallas TPU kernels
(``expand_filter_compact``, ``edge_exists``, ``tile_membership``,
``bitmap_superset``, ``signature_filter``).  ``ragged_expand`` and
``delta_merge_labeled`` are plain tensor code in the reference too and run
as such on every device.  ``delta_merge`` and ``segment_gather_sum`` have
no Hopper kernel yet and raise on a CUDA tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

KERNELS = ("expand_filter_compact", "edge_exists", "tile_membership",
           "bitmap_superset", "signature_filter")
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

# capacity bound of the compaction kernel's one-block scan of block counts
MAX_CAPACITY = 1 << 22


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; anything else raises."""
    types = {t.device.type for t in ts}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in ts}) == 1:
        return True
    raise ValueError(f"kernel inputs must all lie on the CPU or on one CUDA "
                     f"device, got {[str(t.device) for t in ts]}")


def _check(name: str, *ts: torch.Tensor, same_len=(), words=None) -> None:
    """Validate what the kernel takes on trust: contiguous int32 inputs,
    equal lengths for ``same_len``, and ``words = (mask, width)``."""
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 inputs, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
    if len({t.shape for t in same_len}) > 1:
        raise ValueError(f"{name}: length mismatch "
                         f"{[tuple(t.shape) for t in same_len]}")
    if words is not None and words[0].shape != (words[1],):
        raise ValueError(f"{name}: mask shape {tuple(words[0].shape)} does "
                         f"not match {words[1]} bitmap words")


def _launch(name: str, lib: str, *args) -> None:
    """Launch on the current stream: tensors pass as device pointers, ints
    as C ints; a refused launch raises."""
    from repro_torch.kernels._build import kernel

    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = kernel(lib)(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


# --------------------------------------------------------------------------


def edge_exists(nbr, lo, hi, target, n_iters: int = 32):
    """IsJoinable: ``target[i] ∈ nbr[lo[i]:hi[i])``, bool [B]."""
    if not _on_cuda(nbr, lo, hi, target):
        return _ref.edge_exists_ref(nbr, lo, hi, target, n_iters=n_iters)
    _check("edge_exists", nbr, lo, hi, target, same_len=(lo, hi, target))
    n = lo.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=lo.device)
    if n:
        _launch("edge_exists", "edge_exists", nbr, lo, hi, target, out, n,
                max(1, nbr.shape[0]), n_iters)
    return out


def tile_membership(a, b):
    """+INT join: ``out[i, j] = a[i, j] ∈ b[i, :]``, bool [R, TA]."""
    if not _on_cuda(a, b):
        return _ref.tile_membership_ref(a, b)
    _check("tile_membership", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"tile_membership: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not pair rows")
    rows, ta = a.shape
    out = torch.empty((rows, ta), dtype=torch.bool, device=a.device)
    if rows and ta:
        _launch("tile_membership", "tile_membership", a, b, out, rows, ta,
                b.shape[1])
    return out


def bitmap_superset(bitmap, required):
    """Row-wise ``(bitmap & required) == required``, bool [B]."""
    if not _on_cuda(bitmap, required):
        return _ref.bitmap_superset_ref(bitmap, required)
    n, w = bitmap.shape
    _check("bitmap_superset", bitmap, required, words=(required, w))
    out = torch.empty(n, dtype=torch.bool, device=bitmap.device)
    if n:
        _launch("bitmap_superset", "bitmap_superset", bitmap, required,
                out, n, w)
    return out


def signature_filter(sig, v, required):
    """Neighborhood-signature prune probe: gather ``sig[clamp(v)]`` rows and
    superset-test them against ``required``, bool [B]."""
    if not _on_cuda(sig, v, required):
        return _ref.signature_filter_ref(sig, v, required)
    _check("signature_filter", sig, v, required,
           words=(required, sig.shape[1]))
    n = v.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=v.device)
    if n:
        _launch("signature_filter", "signature_filter", sig, v, required,
                out, n, sig.shape[0], sig.shape[1])
    return out


def expand_filter_compact(nbr, bitmap, start, deg, offs, label_mask,
                          bound_id: int, capacity: int):
    """Fused ragged expansion + bitmap filter + order-preserving compaction.
    Returns ``(v_out, row_out, count)`` with ``count`` an int32 scalar
    tensor that stays on the device; see
    :func:`repro_torch.kernels.ref.expand_filter_compact_ref`."""
    if not _on_cuda(nbr, bitmap, start, deg, offs, label_mask):
        return _ref.expand_filter_compact_ref(nbr, bitmap, start, deg, offs,
                                              label_mask, bound_id, capacity)
    _check("expand_filter_compact", nbr, bitmap, start, deg, offs,
           label_mask, same_len=(start, deg, offs),
           words=(label_mask, bitmap.shape[1]))
    if not 0 < capacity <= MAX_CAPACITY:
        raise ValueError(f"expand_filter_compact: capacity {capacity} "
                         f"outside (0, {MAX_CAPACITY}]")
    if offs.shape[0] == 0:
        raise ValueError("expand_filter_compact: no input rows")
    dev = nbr.device
    v_out = torch.empty(capacity, dtype=torch.int32, device=dev)
    row_out = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(-(-capacity // 1024), dtype=torch.int32,
                          device=dev)
    _launch("expand_filter_compact", "expand_filter", nbr,
            max(1, nbr.shape[0]), bitmap, bitmap.shape[0],
            bitmap.shape[1], start, deg, offs,
            offs.shape[0], label_mask, int(bound_id), capacity,
            v_out, row_out, count, scratch)
    return v_out, row_out, count


def ragged_expand(offsets, degrees, capacity: int):
    """Flatten ragged row ranges into slots (plain tensor code on every
    device, as in the reference)."""
    return _ref.ragged_expand_ref(offsets, degrees, capacity)


def delta_merge_labeled(base_nbr, base_lab, delta_nbr, delta_lab, tomb_key,
                        b_start, b_deg, d_start, t_lo, t_hi, j, valid,
                        n_elabels: int, n_iters: int = 32):
    """Predicate-variable live-store expansion (plain tensor code on every
    device, as in the reference)."""
    return _ref.delta_merge_labeled_ref(base_nbr, base_lab, delta_nbr,
                                        delta_lab, tomb_key, b_start, b_deg,
                                        d_start, t_lo, t_hi, j, valid,
                                        n_elabels, n_iters=n_iters)


def delta_merge(base_nbr, delta_nbr, tomb_nbr, b_start, b_deg, d_start,
                t_lo, t_hi, j, valid, n_iters: int = 32):
    """Live-store slot resolution with tombstone masking."""
    if _on_cuda(base_nbr, delta_nbr, tomb_nbr, b_start, j):
        raise NotImplementedError(
            "delta_merge has no Hopper kernel yet (live-store slice)")
    return _ref.delta_merge_ref(base_nbr, delta_nbr, tomb_nbr, b_start,
                                b_deg, d_start, t_lo, t_hi, j, valid,
                                n_iters=n_iters)


def segment_gather_sum(table, indices, segments, num_segments, weights=None):
    """Fused gather + weighted segment-sum."""
    if _on_cuda(table, indices, segments):
        raise NotImplementedError(
            "segment_gather_sum has no Hopper kernel yet")
    return _ref.segment_gather_sum_ref(table, indices, segments,
                                       num_segments, weights=weights)
