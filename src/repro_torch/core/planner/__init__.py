"""repro_torch.core.planner — the cost-based planner subsystem (numpy only).

Layers (bottom-up):

- :mod:`repro_torch.core.planner.ir` — ``ExecPlan`` / ``Step`` / ``NTCheck``,
  the executor's input contract (unchanged from the original ``core.plan``);
- :mod:`repro_torch.core.planner.cost` — ``CostModel`` over the graph's cached
  :class:`~repro_torch.stats.GraphStats`: edge fanout, vertex frequency,
  candidate sets, start-vertex choice;
- :mod:`repro_torch.core.planner.order` — matching-order search: greedy,
  sampled (paper §4.2 candidate-region estimation), and exact subset DP
  for small queries;
- :mod:`repro_torch.core.planner.builder` — ``build_plan``, the single entry
  point for base patterns (``prebound=0``) and OPTIONAL extension plans
  (``prebound=k``: vertices below ``k`` are pre-bound table columns);
- :mod:`repro_torch.core.planner.explain` — plan rendering for
  ``SparqlEngine.explain()`` / ``/sparql?explain=1``.
"""

from repro_torch.core.planner.builder import ESTIMATE_MODES, build_plan
from repro_torch.core.planner.cost import CostModel
from repro_torch.core.planner.explain import explain_plan
from repro_torch.core.planner.ir import (ExecPlan, NTCheck, OrderNotExecutable,
                                   PlanError, Step, np_cmp)
from repro_torch.core.planner.order import (DP_MAX_VERTICES, dp_order, greedy_order,
                                      pvar_first_order, sampled_order)

__all__ = [
    "ESTIMATE_MODES",
    "DP_MAX_VERTICES",
    "CostModel",
    "ExecPlan",
    "NTCheck",
    "OrderNotExecutable",
    "PlanError",
    "Step",
    "build_plan",
    "dp_order",
    "explain_plan",
    "greedy_order",
    "np_cmp",
    "pvar_first_order",
    "sampled_order",
]


def choose_start_vertex(g, q, component):
    """Compatibility wrapper: paper's rank(u) start-vertex choice."""
    return CostModel(g).choose_start_vertex(q, component)
