"""repro_torch.index — neighborhood-signature & summary-graph pruning subsystem.

Two pre-expansion pruning structures in the spirit of TurboHOM++'s
candidate-region exploration and Gai et al.'s summary-graph-driven method:

- :class:`~repro_torch.index.signature.SignatureIndex`: per-vertex packed uint32
  bitmaps of incident predicates per direction (hash-folded superset
  probes, same contract as ``repro_torch.kernels.ops.bitmap_superset``).  A query
  vertex's *required signature* (predicates its data match must have) is
  tested against the index to prune start candidates in the planner and
  expansion frontiers in the executor step loop.
- :class:`~repro_torch.index.summary.SummaryGraph`: a coarse graph over vertex
  classes with per-(class, predicate, class) edge counts; the planner's
  :class:`~repro_torch.core.planner.cost.CostModel` consults it for join
  selectivities instead of the label-frequency heuristic.

Both are built once per :class:`~repro_torch.rdf.graph.LabeledGraph` (cached on
the graph), over-approximated conservatively on live-store snapshots
(insert bits OR-ed in, tombstones ignored — pruning stays sound), and
patched *exactly* at :meth:`VersionedStore.compact` (asserted against a
rebuild in tests, the same contract as ``GraphStats``).
"""

from repro_torch.index.signature import (SignatureIndex, get_index, patch_index,
                                   prune_candidates, required_signature,
                                   signature_rows)
from repro_torch.index.summary import (SummaryGraph, get_summary, patch_summary)

__all__ = [
    "SignatureIndex", "get_index", "patch_index", "prune_candidates",
    "required_signature", "signature_rows",
    "SummaryGraph", "get_summary", "patch_summary",
]
