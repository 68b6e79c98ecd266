"""Kernel dispatch by device.

A CPU tensor goes to the plain PyTorch version in :mod:`ref`; a CUDA
tensor goes to the hand-written Hopper kernel, or the call raises.  Nothing
else picks the path: no environment switch, no fallback.  Each kernel
wrapper adds one to ``launches[name]`` where it launches its kernel and
nowhere else, so a run can show which kernels it went through.  Several
threads may launch at once (the serving scheduler's workers): the counts
and the compaction kernel's host-side scratch table change under one lock.

The seven kernels replace the reference's Pallas TPU kernels:
``expand_filter_compact``, ``edge_exists``, ``tile_membership``,
``bitmap_superset`` and ``signature_filter`` on every query,
``delta_merge`` on live-store snapshots, and ``segment_gather`` behind
``segment_gather_fixed`` / ``segment_gather_sum`` (the embedding-bag / GNN
aggregation entry points; :class:`EmbeddingBagSum` is the fixed form with
its gradient, the model zoo's embedding bag).  ``ragged_expand`` and
``delta_merge_labeled`` are plain tensor code in the reference too and run
as such on every device.

Each kernel is an operator of the ``repro_torch`` namespace (:func:`_op`),
its body registered for CPU and CUDA tensors and a shape function beside
it: under ``FakeTensorMode`` (the dry run's trace) the dispatcher calls
the shape function, so a fake tensor reaches neither a launch nor a plain
version, and the trace sees the kernel as one op by its name.  The public
wrappers below keep their Python signatures and call the operators.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.autograd import (EmbeddingBagSum,  # noqa: F401
                                          embedding_bag_sum)

KERNELS = ("expand_filter_compact", "edge_exists", "tile_membership",
           "bitmap_superset", "signature_filter", "delta_merge",
           "segment_gather")
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
# guards ``launches``, ``_EFC_SCRATCH`` and ``_PAD`` across threads
_LOCK = threading.Lock()

# the compaction kernel writes int32 positions, as the reference's int32
# tables hold them: its one capacity bound
_INT32_MAX = 2**31 - 1
# its look-back status buffer holds a word per tile (1024 slots from
# capacity 2^17, at most 256 smaller tiles below), then its ticket word; a
# buffer holds at least this many status words and grows with the calls
_EFC_MIN_TILES = 4096
# calls on one buffer before it is zeroed again: the kernel tags status
# words with the call's epoch modulo 2^31, so no old word is mistaken for
# the current call's
_EFC_EPOCH_PERIOD = 1 << 30
# (device index, stream) -> [status buffer, calls made on it since zeroed]
_EFC_SCRATCH: dict[tuple[int, int], list] = {}


_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def _op(schema: str, fake):
    """Register the decorated body as the operator ``repro_torch::<name>``
    of ``schema``, for CPU and CUDA tensors, with ``fake`` (the same
    arguments, outputs of the contract's shapes) as its shape function,
    which also refuses inputs on two devices; returns the operator."""
    name = schema.split("(", 1)[0]

    def shapes(*args):
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) > 1:
            raise ValueError(f"kernel inputs must all lie on one device, "
                             f"got {sorted(map(str, devices))}")
        return fake(*args)

    def register(body):
        _LIB.define(schema)
        for key in ("CPU", "CUDA"):
            _LIB.impl(name, body, key)
        torch.library.register_fake(f"repro_torch::{name}", shapes, lib=_LIB)
        return getattr(torch.ops.repro_torch, name).default

    return register


def _bools(n: int, like: torch.Tensor) -> torch.Tensor:
    return like.new_empty(n, dtype=torch.bool)


def reset_launches() -> None:
    with _LOCK:
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


def _launch(name: str, entry: str, *args) -> None:
    """Launch ``entry`` (a launcher of ``_build.SIGNATURES``) on the current
    stream, counted as a launch of kernel ``name``: tensors pass as device
    pointers, ints as C ints; a refused launch raises."""
    from repro_torch.kernels._build import kernel

    # (None passes as a null pointer: an absent optional array)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = kernel(entry)(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _LOCK:
        launches[name] += 1


# --------------------------------------------------------------------------


def edge_exists(nbr, lo, hi, target, n_iters: int = 32):
    """IsJoinable: ``target[i] ∈ nbr[lo[i]:hi[i])``, bool [B]."""
    return _edge_exists(nbr, lo, hi, target, n_iters)


@_op("edge_exists(Tensor nbr, Tensor lo, Tensor hi, Tensor target, "
     "int n_iters) -> Tensor",
     lambda nbr, lo, hi, target, n_iters: _bools(lo.shape[0], lo))
def _edge_exists(nbr, lo, hi, target, n_iters):
    if not _on_cuda(nbr, lo, hi, target):
        return _ref.edge_exists_ref(nbr, lo, hi, target, n_iters=n_iters)
    _check("edge_exists", nbr, lo, hi, target, same_len=(lo, hi, target))
    n = lo.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=lo.device)
    if n:
        _launch("edge_exists", "edge_exists", nbr, lo, hi, target, out, n,
                max(1, nbr.shape[0]), n_iters)
    return out


def tile_membership(a, b, iptr=None, probe=None, tb=None):
    """+INT join: ``out[i, j] = a[i, j] ∈ b[i, :]``, bool [R, TA].

    The range form (``iptr``, ``probe`` and ``tb`` given) builds each row's
    tile in the same launch, as the executor builds its ``adj_tile``:
    ``b`` is the flat adjacency ``nbr``, ``a`` the candidates ``v`` [R],
    and ``out[i] = v[i] >= 0 and v[i] ∈ nbr[lo : min(hi, lo + tb))`` with
    ``lo, hi = iptr[p], iptr[p + 1]`` and ``p = clamp(probe[i], 0, n - 1)``,
    ``n = len(iptr) - 1``; bool [R].  ``probe`` may be a strided view (a
    binding-table column).  See
    :func:`repro_torch.kernels.ref.tile_membership_ref`."""
    if iptr is None:
        return _tile_membership(a, b)
    if probe is None or tb is None:
        raise ValueError("tile_membership: the range form takes iptr, probe "
                         "and tb")
    return _tile_range(a, b, iptr, probe, tb)


@_op("tile_membership(Tensor a, Tensor b) -> Tensor",
     lambda a, b: a.new_empty(a.shape, dtype=torch.bool))
def _tile_membership(a, b):
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


@_op("tile_membership_range(Tensor v, Tensor nbr, Tensor iptr, "
     "Tensor probe, int tb) -> Tensor",
     lambda v, nbr, iptr, probe, tb: _bools(v.shape[0], v))
def _tile_range(v, nbr, iptr, probe, tb):
    if not _on_cuda(v, nbr, iptr, probe):
        return _ref.tile_membership_ref(v, nbr, iptr=iptr, probe=probe,
                                        tb=tb)
    _check("tile_membership", v, nbr, iptr)
    if probe.dtype != torch.int32 or probe.ndim != 1 or v.ndim != 1 \
            or probe.shape != v.shape or iptr.shape[0] < 2 or tb < 0:
        raise ValueError(f"tile_membership: range form with v "
                         f"{tuple(v.shape)}, probe {probe.dtype} "
                         f"{tuple(probe.shape)}, iptr {tuple(iptr.shape)}, "
                         f"tb {tb}")
    rows = v.shape[0]
    out = torch.empty(rows, dtype=torch.bool, device=v.device)
    if rows and nbr.shape[0]:
        _launch("tile_membership", "tile_membership_range", nbr,
                nbr.shape[0], iptr, iptr.shape[0] - 1, probe,
                probe.stride(0), v, rows, tb, out)
    elif rows:
        out.zero_()  # an empty adjacency holds nothing
    return out


def _probe(name: str, table, ids, required):
    """One launch of the superset probe that ``bitmap_superset`` and
    ``signature_filter`` share: rows ``table[clamp(ids)]``, or every row of
    ``table`` when ``ids`` is None."""
    _check(name, table, required, *(() if ids is None else (ids,)),
           words=(required, table.shape[1]))
    n = table.shape[0] if ids is None else ids.shape[0]
    # the kernel stores 4 results as one 32-bit word from the ids' first
    # 16-byte boundary (``head`` ids in): place out so that word is aligned
    head = 0 if ids is None else -ids.data_ptr() % 16 // 4
    if head == 0:
        out = torch.empty(n, dtype=torch.bool, device=table.device)
    else:
        out = torch.empty(n + 3, dtype=torch.bool,
                          device=table.device)[-head % 4:][:n]
    if n:
        # rows as 8-byte words where the table is 8-byte aligned and rows
        # even
        wide = int(table.data_ptr() % 8 == 0 and table.shape[1] % 2 == 0)
        _launch(name, name, table, ids, required, out, n, table.shape[0],
                table.shape[1], wide)
    return out


def bitmap_superset(bitmap, required, ids=None):
    """Row-wise ``(bitmap & required) == required``, bool [B].  With int32
    ``ids`` the rows ``bitmap[clamp(ids, 0, V-1)]`` are tested in the same
    launch (no gathered copy), bool [len(ids)]."""
    return _bitmap_superset(bitmap, required, ids)


@_op("bitmap_superset(Tensor bitmap, Tensor required, Tensor? ids) -> "
     "Tensor",
     lambda bitmap, required, ids: _bools(
         bitmap.shape[0] if ids is None else ids.shape[0], bitmap))
def _bitmap_superset(bitmap, required, ids):
    ts = (bitmap, required) if ids is None else (bitmap, required, ids)
    if not _on_cuda(*ts):
        return _ref.bitmap_superset_ref(bitmap, required, ids=ids)
    return _probe("bitmap_superset", bitmap, ids, required)


def signature_filter(sig, v, required):
    """Neighborhood-signature prune probe: gather ``sig[clamp(v)]`` rows and
    superset-test them against ``required``, bool [B]."""
    return _signature_filter(sig, v, required)


@_op("signature_filter(Tensor sig, Tensor v, Tensor required) -> Tensor",
     lambda sig, v, required: _bools(v.shape[0], v))
def _signature_filter(sig, v, required):
    if not _on_cuda(sig, v, required):
        return _ref.signature_filter_ref(sig, v, required)
    return _probe("signature_filter", sig, v, required)


def expand_filter_compact(nbr, bitmap, start, deg, offs, label_mask,
                          bound_id, capacity: int):
    """Fused ragged expansion + bitmap filter + order-preserving compaction.
    ``bound_id`` is a one-element int32 tensor on the inputs' device
    (``< 0``: no check): a step's baked scalar, or ``params[slot]`` of a
    parameterized plan (a view, so no copy), and the kernel reads it on the
    device, so nothing is read back.  Returns
    ``(v_out, row_out, count)`` with ``count`` an int32 scalar tensor that
    stays on the device; see
    :func:`repro_torch.kernels.ref.expand_filter_compact_ref`."""
    if bound_id.numel() != 1:
        raise ValueError(f"expand_filter_compact: a bound id of "
                         f"{bound_id.numel()} elements, expected 1")
    return _expand_filter_compact(nbr, bitmap, start, deg, offs, label_mask,
                                  bound_id, capacity)


def _efc_fake(nbr, bitmap, start, deg, offs, label_mask, bound_id,
              capacity):
    return (nbr.new_empty(capacity), nbr.new_empty(capacity),
            nbr.new_empty(()))


@_op("expand_filter_compact(Tensor nbr, Tensor bitmap, Tensor start, "
     "Tensor deg, Tensor offs, Tensor label_mask, Tensor bound_id, "
     "int capacity) -> (Tensor, Tensor, Tensor)", _efc_fake)
def _expand_filter_compact(nbr, bitmap, start, deg, offs, label_mask,
                           bound_id, capacity):
    if not _on_cuda(nbr, bitmap, start, deg, offs, label_mask, bound_id):
        return _ref.expand_filter_compact_ref(nbr, bitmap, start, deg, offs,
                                              label_mask, bound_id, capacity)
    _check("expand_filter_compact", nbr, bitmap, start, deg, offs,
           label_mask, bound_id, same_len=(start, deg, offs),
           words=(label_mask, bitmap.shape[1]))
    if not 0 < capacity <= _INT32_MAX:
        raise ValueError(f"expand_filter_compact: capacity {capacity} "
                         f"outside (0, 2^31 - 1]: the compacted tables hold "
                         f"int32 positions")
    if offs.shape[0] == 0:
        raise ValueError("expand_filter_compact: no input rows")
    dev = nbr.device
    v_out = torch.empty(capacity, dtype=torch.int32, device=dev)
    row_out = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = _efc_scratch(dev, max(_EFC_MIN_TILES, -(-capacity // 1024)))
    _launch("expand_filter_compact", "expand_filter", nbr,
            max(1, nbr.shape[0]), bitmap, bitmap.shape[0],
            bitmap.shape[1], start, deg, offs,
            offs.shape[0], label_mask, bound_id, capacity,
            v_out, row_out, count, scratch, scratch.shape[0])
    return v_out, row_out, count


def _efc_scratch(dev: torch.device, tiles: int) -> torch.Tensor:
    """The compaction kernel's look-back status words (at least ``tiles``)
    and ticket word for the current stream of ``dev``, so calls on one
    stream share it and calls on two streams never do.  It is zeroed when
    made, made anew (zeroed, larger) when a call needs more status words,
    and zeroed again once every ``_EFC_EPOCH_PERIOD`` calls; in between,
    each call moves the epoch kept in it on by one, on the device.  A
    buffer left for a larger one is freed into the caching allocator, which
    hands it out again only after this stream's earlier work."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _LOCK:
        entry = _EFC_SCRATCH.get(key)
        if entry is None or entry[0].shape[0] < tiles + 1:
            entry = _EFC_SCRATCH[key] = [
                torch.zeros(tiles + 1, dtype=torch.int64, device=dev), 0]
        elif entry[1] >= _EFC_EPOCH_PERIOD:
            entry[0].zero_()
            entry[1] = 0
        entry[1] += 1
        return entry[0]


def ragged_expand(offsets, degrees, capacity: int):
    """Flatten ragged row ranges into slots (plain tensor code on every
    device, as in the reference)."""
    return _ref.ragged_expand_ref(offsets, degrees, capacity)


def delta_merge_labeled(base_nbr, base_lab, delta_nbr, delta_lab, tomb_key,
                        b_start, b_deg, d_start, t_lo, t_hi, j, valid,
                        n_elabels: int, n_iters: int = 32):
    """Predicate-variable live-store expansion (plain tensor code on every
    device, as in the reference).  ``delta_nbr``, ``delta_lab`` and
    ``tomb_key`` may be ``None`` or empty, as in :func:`delta_merge`."""
    delta_nbr, delta_lab, tomb_key = (_one_slot(a, base_nbr) for a in
                                      (delta_nbr, delta_lab, tomb_key))
    return _ref.delta_merge_labeled_ref(base_nbr, base_lab, delta_nbr,
                                        delta_lab, tomb_key, b_start, b_deg,
                                        d_start, t_lo, t_hi, j, valid,
                                        n_elabels, n_iters=n_iters)


_PAD: dict[torch.device, torch.Tensor] = {}


def _one_slot(a: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """An absent (``None``) or zero-length int32 adjacency array reads as
    one slot of -1, as the reference's kernel pads it (every read of it is
    clamped into range).  The pad is made once per device and only read;
    it is complete before any thread can read it, whatever its stream."""
    if a is not None and a.shape[0]:
        return a
    with _LOCK:
        pad = _PAD.get(like.device)
        if pad is None:
            pad = torch.full((1,), -1, dtype=torch.int32, device=like.device)
            if pad.is_cuda:
                torch.cuda.current_stream(like.device).synchronize()
            _PAD[like.device] = pad
    return pad


def delta_merge(base_nbr, delta_nbr, tomb_nbr, b_start, b_deg, d_start,
                t_lo, t_hi, j, valid, n_iters: int = 32, row=None):
    """Live-store slot resolution with tombstone masking: slot position
    ``j < b_deg`` reads ``base_nbr[b_start + j]``, later positions
    ``delta_nbr[d_start + j - b_deg]``; a base candidate found in
    ``tomb_nbr[t_lo:t_hi)`` is masked.  Returns ``(v, ok)``: int32 ``v``
    (-1 where not ``valid``) and bool ``ok``.  An adjacency array may be
    ``None`` (the direction has no delta or no tombstones) or empty.

    The five fields are per slot, or, with int32 ``row``, row-level: slot
    ``i`` reads ``field[clamp(row[i])]`` in the same launch (no per-slot
    copies).  ``d_start``, ``t_lo`` and ``t_hi`` may be ``None`` and then
    read as 0.  See :func:`repro_torch.kernels.ref.delta_merge_ref`."""
    return _delta_merge(base_nbr, delta_nbr, tomb_nbr, b_start, b_deg,
                        d_start, t_lo, t_hi, j, valid, n_iters, row)


def _delta_merge_fake(base_nbr, delta_nbr, tomb_nbr, b_start, b_deg,
                      d_start, t_lo, t_hi, j, valid, n_iters, row):
    return (j.new_empty(j.shape[0], dtype=torch.int32),
            _bools(j.shape[0], j))


@_op("delta_merge(Tensor? base_nbr, Tensor? delta_nbr, Tensor? tomb_nbr, "
     "Tensor? b_start, Tensor? b_deg, Tensor? d_start, Tensor? t_lo, "
     "Tensor? t_hi, Tensor j, Tensor valid, int n_iters, Tensor? row) -> "
     "(Tensor, Tensor)", _delta_merge_fake)
def _delta_merge(base_nbr, delta_nbr, tomb_nbr, b_start, b_deg, d_start,
                 t_lo, t_hi, j, valid, n_iters, row):
    fields = (b_start, b_deg, d_start, t_lo, t_hi)
    base_nbr, delta_nbr, tomb_nbr = (_one_slot(a, j) for a in
                                     (base_nbr, delta_nbr, tomb_nbr))
    given = [f for f in fields if f is not None]
    per_slot = (j,) + (tuple(given) if row is None else (row,))
    if not _on_cuda(base_nbr, delta_nbr, tomb_nbr, *given, *per_slot,
                    valid):
        return _ref.delta_merge_ref(base_nbr, delta_nbr, tomb_nbr, *fields,
                                    j, valid, n_iters=n_iters, row=row)
    if b_start is None or b_deg is None:
        raise ValueError("delta_merge: b_start and b_deg are required")
    _check("delta_merge", base_nbr, delta_nbr, tomb_nbr, *given, *per_slot,
           same_len=(*per_slot, valid))
    _check("delta_merge", same_len=given)
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError(f"delta_merge: expected a contiguous bool valid "
                         f"mask, got {valid.dtype}")
    k = j.shape[0]
    n_fields = b_start.shape[0]
    if row is not None and k and not n_fields:
        raise ValueError("delta_merge: row ids into empty field arrays")
    v = torch.empty(k, dtype=torch.int32, device=j.device)
    ok = torch.empty(k, dtype=torch.bool, device=j.device)
    if k:
        _launch("delta_merge", "delta_merge", base_nbr, base_nbr.shape[0],
                delta_nbr, delta_nbr.shape[0], tomb_nbr, tomb_nbr.shape[0],
                *fields, row, n_fields, j, valid, v, ok, k, n_iters)
    return v, ok


_GATHER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gather_out(table, weights, s: int):
    """Check the table, cast the weights to its dtype, and allocate the
    ``[s, D]`` output of a ``segment_gather`` launch."""
    if table.ndim != 2 or table.dtype not in _GATHER_DTYPES \
            or not table.is_contiguous():
        raise ValueError(f"segment_gather: expected a contiguous [V, D] "
                         f"float32 or bfloat16 table, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if table.shape[0] == 0:
        raise ValueError("segment_gather: empty table")
    if weights is not None:
        weights = weights.to(table.dtype).contiguous()
    out = torch.empty((s, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return weights, out


def segment_gather_fixed(table, idx, weights=None):
    """Fused gather + weighted sum over the fixed-hotness layout:
    ``out[s] = Σ_k w[s, k] · table[idx[s, k]]`` for ``idx int32 [S, K]``
    (``< 0``: padding; ``≥ V``: row ``V-1``), float32 accumulation, the
    table's dtype out.  See
    :func:`repro_torch.kernels.ref.segment_gather_fixed_ref`."""
    return _segment_gather_fixed(table, idx, weights)


@_op("segment_gather_fixed(Tensor table, Tensor idx, Tensor? weights) -> "
     "Tensor",
     lambda table, idx, weights: table.new_empty((idx.shape[0],
                                                  table.shape[1])))
def _segment_gather_fixed(table, idx, weights):
    ts = (table, idx) if weights is None else (table, idx, weights)
    if not _on_cuda(*ts):
        return _ref.segment_gather_fixed_ref(table, idx, weights=weights)
    _check("segment_gather", idx)
    if idx.ndim != 2 or (weights is not None
                         and weights.shape != idx.shape):
        raise ValueError(f"segment_gather_fixed: idx {tuple(idx.shape)} "
                         f"must be [S, K] and weights of the same shape")
    s, k = idx.shape
    weights, out = _gather_out(table, weights, s)
    if s and table.shape[1]:
        _launch("segment_gather", "segment_gather", table, table.shape[0],
                table.shape[1], _GATHER_DTYPES[table.dtype], idx, weights, k,
                s, out)
    return out


def segment_gather_sum(table, indices, segments, num_segments, weights=None):
    """Fused gather + weighted segment-sum over ragged ``(indices,
    segments)`` entries (the reference's semantics: a negative index counts
    from the end and then clamps into ``[0, V-1]``; an entry whose segment
    lies outside ``[0, num_segments)`` is dropped; see
    :func:`repro_torch.kernels.ref.segment_gather_sum_ref`).

    On CUDA the segment keys are sorted on the device (a stable sort, so
    each segment's run keeps its entries' order; keys below 0 sort before
    segment 0's run and keys from ``num_segments`` on after the last run,
    so no run holds a dropped entry), and ``searchsorted`` finds each
    segment's run in the permutation.  The gather-sum is then one
    ``segment_gather`` launch, which reads the permutation itself
    (:func:`_gather_sum_launch`).  There is no hotness or table-size
    bound."""
    return _segment_gather_sum(table, indices, segments, num_segments,
                               weights)


@_op("segment_gather_sum(Tensor table, Tensor indices, Tensor segments, "
     "int num_segments, Tensor? weights) -> Tensor",
     lambda table, indices, segments, num_segments, weights:
     table.new_empty((num_segments, table.shape[1])))
def _segment_gather_sum(table, indices, segments, num_segments, weights):
    ts = (table, indices, segments) + (() if weights is None else (weights,))
    if not _on_cuda(*ts):
        return _ref.segment_gather_sum_ref(table, indices, segments,
                                           num_segments, weights=weights)
    _check("segment_gather", indices, segments,
           same_len=(indices, segments))
    if weights is not None and weights.shape != indices.shape:
        raise ValueError(f"segment_gather_sum: weights {tuple(weights.shape)}"
                         f" do not match {tuple(indices.shape)} entries")
    seg, order = torch.sort(segments, stable=True)
    offsets = torch.searchsorted(
        seg, torch.arange(num_segments + 1, dtype=torch.int32,
                          device=seg.device), out_int32=True)
    return _gather_sum_launch(table, indices, weights, order, offsets,
                              num_segments)


def _gather_sum_launch(table, indices, weights, order, offsets, s: int):
    """The ragged ``segment_gather`` launch: segment ``i`` sums the entries
    at positions ``order[offsets[i]:offsets[i+1]]`` (int64 positions into
    ``indices`` and ``weights``, as ``torch.sort`` returns them), in that
    order.  Rows are read as 16-byte vectors where ``D`` and the table's
    base allow, else as 4-byte columns; the sums are the same."""
    weights, out = _gather_out(table, weights, s)
    d = table.shape[1]
    if s and d:
        vec = int(table.data_ptr() % 16 == 0
                  and d % (16 // table.element_size()) == 0)
        _launch("segment_gather", "segment_gather_sum", table,
                table.shape[0], d, _GATHER_DTYPES[table.dtype], vec, indices,
                weights, order, offsets, s, out)
    return out
