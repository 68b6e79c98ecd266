"""Plan intermediate representation: the executor's input contract.

``ExecPlan`` / ``Step`` / ``NTCheck`` are exactly what
:mod:`repro_torch.core.exec` compiles into a jitted chunk program; the planner
packages (:mod:`~repro_torch.core.planner.cost`, ``order``, ``builder``) only
ever *produce* these.  The executor-facing fields are unchanged from the
original ``core.plan`` module; ``est_rows`` / ``search`` / ``build_ms``
are planner diagnostics consumed by ``SparqlEngine.explain()`` and the
serving metrics, and do not participate in ``signature()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.query import QueryGraph


class PlanError(ValueError):
    pass


class OrderNotExecutable(PlanError):
    """The chosen matching order cannot run (e.g. it would check a
    predicate variable before any tree edge binds it).  ``build_plan``
    retries these once with a pvar-first order before giving up."""


@dataclass
class NTCheck:
    """Non-tree edge check executed when query vertex ``u`` is bound.

    The query edge is (other --elabel--> u) if ``forward`` else
    (u --elabel--> other); ``other`` is bound earlier in the order.
    """

    other: int
    elabel: int
    forward: bool
    pvar_idx: int = -1  # >= 0: edge label is that predicate variable's binding
    self_loop: bool = False  # query self-loop checked against u itself


@dataclass
class Step:
    u: int
    parent: int  # -1 for a cross-component restart step
    elabel: int  # -1 = predicate variable
    forward: bool  # parent --el--> u (out CSR) vs u --el--> parent (in CSR)
    pvar_idx: int = -1
    labels: tuple[int, ...] = ()
    bound_id: int = -1
    nontree: tuple[NTCheck, ...] = ()
    min_out_ntypes: int = 0  # hom-weakened degree filter constants
    min_in_ntypes: int = 0
    nlf_out_mask: np.ndarray | None = None  # uint32 words over neighbor types
    nlf_in_mask: np.ndarray | None = None
    num_filters: tuple[tuple[str, float], ...] = ()
    optional_group: int = -1  # -1 = required pattern
    # >= 0: the bound-id equality check reads params[param_slot] (a traced
    # scalar input of the chunk program) instead of the baked ``bound_id``
    param_slot: int = -1
    # restart steps expand the table by this component's start candidates
    restart_candidates: np.ndarray | None = None
    # required neighborhood signature (repro_torch.index; uint32 [2W]) — tree
    # steps probe it in the executor step loop, restart steps re-apply it
    # when snapshot execution re-resolves their candidates.  Derived from
    # plan structure + graph, so (like the NLF masks) not in signature().
    sig_mask: np.ndarray | None = None


@dataclass
class ExecPlan:
    query: QueryGraph
    start_vertex: int
    start_candidates: np.ndarray  # int32, sorted
    steps: list[Step]
    order: list[int]  # query vertex order (including start)
    n_pvars: int
    unsat: bool = False
    # cheap numeric filters applied to the start candidates on the host —
    # kept as a *spec* so snapshot execution (live store) can re-resolve
    # the candidate set against a newer graph version than the plan's
    start_num_filters: tuple = ()
    # start-vertex required signature — the snapshot re-resolution spec,
    # exactly like ``start_num_filters`` (the baked candidate array already
    # has it applied)
    start_sig: np.ndarray | None = None
    # parameterized plans: number of constant slots (0 = fully baked) and
    # the start vertex's slot when the start itself is parameterized (the
    # executor then resolves start candidates from params at run time)
    n_params: int = 0
    start_param_slot: int = -1
    # estimated fanout per step (for capacity presizing)
    est_fanout: list[float] = field(default_factory=list)
    # raw per-step expansion factor (candidates produced per input row
    # BEFORE filtering) — what the executor's per-step capacity schedule
    # must hold, as opposed to ``est_fanout`` (rows surviving the filters)
    est_expand: list[float] = field(default_factory=list)
    # planner diagnostics (explain() / metrics; not part of the signature)
    est_rows: list[float] = field(default_factory=list)  # cumulative, per step
    search: str = "greedy"  # which order search produced this plan
    build_ms: float = 0.0  # wall time spent planning

    def signature(self) -> tuple:
        """Hashable identity for the compiled-executable cache."""
        return (
            self.start_vertex,
            tuple(
                (
                    s.u, s.parent, s.elabel, s.forward, s.pvar_idx, s.labels,
                    s.bound_id, s.min_out_ntypes, s.min_in_ntypes,
                    tuple((c.other, c.elabel, c.forward, c.pvar_idx, c.self_loop)
                          for c in s.nontree),
                    s.num_filters, s.optional_group, s.param_slot,
                    None if s.restart_candidates is None
                    else len(s.restart_candidates),
                )
                for s in self.steps
            ),
            self.n_pvars,
            self.n_params,
            self.start_param_slot,
        )

    def capacity_schedule(self, chunk: int, init_cap: int, max_cap: int,
                          slack: float = 1.0) -> tuple[int, ...]:
        """Per-step binding-table capacities for a chunk of ``chunk`` rows.

        ``caps[i]`` bounds the candidates step ``i`` may expand to; it is
        derived from the cumulative row estimate times the step's raw
        expansion factor (``est_expand``), widened by ``slack``, rounded up
        to a power of two (bounding executor recompiles to pow2 buckets),
        floored at ``min(init_cap, max_cap)``, and made monotone
        non-decreasing so an overflow-frozen table can always be carried
        forward losslessly.  Estimation errors are corrected at run time by
        the executor's suffix-resume doubling, so these are starting
        points, not guarantees.
        """
        cap_in = _next_pow2(chunk)
        floor = max(cap_in, min(_next_pow2(init_cap), max_cap))
        caps: list[int] = []
        # the planner's cumulative row estimates are for the full start set;
        # scale them down to one chunk (extension plans have no start set —
        # their est_rows are per-input-row multipliers, i.e. n0 == 1)
        n0 = max(1, self.start_candidates.shape[0])
        scale = chunk / n0 if self.start_candidates.shape[0] else float(chunk)
        rows = float(chunk)
        prev = floor
        for i in range(len(self.steps)):
            raw = self.est_expand[i] if i < len(self.est_expand) else 1.0
            need = rows * max(raw, 1.0) * slack
            c = _next_pow2(int(min(need, float(max_cap))))
            c = min(max_cap, max(prev, c))
            caps.append(c)
            prev = c
            if i < len(self.est_rows):
                rows = max(1.0, self.est_rows[i] * scale)
            else:
                f = self.est_fanout[i] if i < len(self.est_fanout) else 1.0
                rows = max(1.0, rows * min(max(f, 1e-3), 256.0))
        return tuple(caps)

    def estimated_rows(self) -> float:
        """Final estimated result cardinality.  A plan with no steps (point
        query / pure extension) is exactly its start-candidate count."""
        if self.unsat:
            return 0.0
        if self.est_rows:
            return self.est_rows[-1]
        return float(max(1, self.start_candidates.shape[0]))


def _next_pow2(x: int) -> int:
    return 1 << max(3, (max(1, x) - 1).bit_length())


def np_cmp(vals: np.ndarray, op: str, c: float) -> np.ndarray:
    if op == "<":
        return vals < c
    if op == "<=":
        return vals <= c
    if op == ">":
        return vals > c
    if op == ">=":
        return vals >= c
    if op == "=":
        return vals == c
    if op == "!=":
        return vals != c
    raise ValueError(op)
