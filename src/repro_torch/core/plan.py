"""Compatibility shim — the planner lives in :mod:`repro_torch.core.planner`.

Graph statistics live in :mod:`repro_torch.stats` (built once per graph and
cached on it); the cost model, the order search and the unified base /
extension plan builder live in :mod:`repro_torch.core.planner`.  This
module re-exports the public names under the reference's old module path,
so code written against ``core.plan`` keeps working.
"""

from __future__ import annotations

from repro_torch.core.planner import (ExecPlan, NTCheck, PlanError, Step,
                                      build_plan, choose_start_vertex, np_cmp)
from repro_torch.core.planner.builder import _nlf_masks  # noqa: F401 (compat)

# legacy private alias (pre-planner callers imported this name)
_np_cmp = np_cmp

__all__ = [
    "ExecPlan",
    "NTCheck",
    "PlanError",
    "Step",
    "build_plan",
    "choose_start_vertex",
    "np_cmp",
]
