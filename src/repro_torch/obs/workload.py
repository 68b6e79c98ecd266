"""Cardinality q-error, as ``SparqlEngine.explain(analyze=True)`` reports
it for each step and for the whole query."""

from __future__ import annotations


def qerror(estimated: float, actual: float) -> float:
    """Symmetric relative cardinality error, >= 1.0 (1.0 = exact).

    Both sides are +1-smoothed so empty results don't divide by zero.
    """
    e = max(0.0, float(estimated)) + 1.0
    a = max(0.0, float(actual)) + 1.0
    return max(e / a, a / e)
