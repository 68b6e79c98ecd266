"""repro_torch.stats — graph statistics shared by the cost-based planner.

``get_stats(graph)`` builds a :class:`GraphStats` once per
:class:`~repro_torch.rdf.graph.LabeledGraph` and caches it on the graph object:
per-predicate cardinalities, per-direction fanout tables, label frequency /
cooccurrence, and a bounded-sample join-cardinality estimator.
"""

from repro_torch.stats.graph_stats import GraphStats, get_stats, patch_stats

__all__ = ["GraphStats", "get_stats", "patch_stats"]
