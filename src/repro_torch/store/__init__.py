"""repro_torch.store — versioned live RDF store with delta-aware snapshots.

A :class:`VersionedStore` keeps the frozen base :class:`LabeledGraph` plus
an in-memory delta overlay (COO insert buffers and tombstones over base
edges) and hands out cheap immutable :class:`Snapshot` views that queries
execute against while writers keep appending.  The executor merges
base-CSR adjacency with the snapshot's small sorted delta adjacency per
expansion step (``kernels.ops.delta_merge``, a hand-written Hopper kernel
on the card), so no CSR rebuild happens on the write path; a
threshold-triggered compaction folds the delta into a fresh
``LabeledGraph`` and patches the cached statistics and indexes.

SPARQL UPDATE (``INSERT DATA`` / ``DELETE DATA``) is parsed by
:mod:`repro_torch.store.update_parser`.
"""

from repro_torch.store.delta import EdgeDelta
from repro_torch.store.update_parser import UpdateError, UpdateOp, parse_update
from repro_torch.store.versioned import Snapshot, VersionedStore

__all__ = [
    "EdgeDelta",
    "Snapshot",
    "VersionedStore",
    "UpdateError",
    "UpdateOp",
    "parse_update",
]
