"""Carry a graph and a plan across from their plain fields.

The weights of this system are its data: a :class:`LabeledGraph`'s CSR
arrays and an :class:`ExecPlan`.  ``graph_fields`` / ``plan_fields`` read
them out of any object with the same fields (the reference package's
graph and plan included) into plain ints, tuples, dicts and numpy arrays;
``graph_from_arrays`` / ``plan_from_fields`` build the port's objects from
those.  The same plan on the same graph can then run through two
executors, so executor parity does not depend on the generator or the
planner.

The zoo's weights carry across the same way: ``params_from_jax`` turns the
reference's parameter pytree into the port module's ``state_dict`` and
``adam_state_from_jax`` its optimizer state, so one trajectory can be
resumed in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.planner.ir import ExecPlan, NTCheck, Step
from repro_torch.core.query import QEdge, QueryGraph, QVertex
from repro_torch.rdf.graph import LabeledGraph, _Direction

_DIRECTION = ("indptr_el", "nbr_el", "indptr_all", "nbr_all", "lab_all",
              "degree")
_GRAPH = ("n_vertices", "n_elabels", "n_vlabels", "label_bitmap",
          "vl_indptr", "vl_vertices", "numeric_value")


def graph_fields(g) -> dict:
    """A graph's fields as plain values: ``out_<field>`` / ``in_<field>``
    per direction plus the vertex-side arrays and counts."""
    d = {name: getattr(g, name) for name in _GRAPH}
    for prefix, dirn in (("out", g.out), ("in", g.inc)):
        for name in _DIRECTION:
            d[f"{prefix}_{name}"] = np.array(getattr(dirn, name))
    d["vlabel_sets"] = [tuple(s) for s in g.vlabel_sets]
    return d


def graph_from_arrays(d: dict) -> LabeledGraph:
    """The port's graph from :func:`graph_fields`-shaped values."""
    def direction(prefix: str) -> _Direction:
        return _Direction(**{name: np.array(d[f"{prefix}_{name}"])
                             for name in _DIRECTION})

    nv = d.get("numeric_value")
    return LabeledGraph(
        n_vertices=int(d["n_vertices"]),
        n_elabels=int(d["n_elabels"]),
        n_vlabels=int(d["n_vlabels"]),
        out=direction("out"),
        inc=direction("in"),
        label_bitmap=np.array(d["label_bitmap"], dtype=np.uint32),
        vl_indptr=np.array(d["vl_indptr"]),
        vl_vertices=np.array(d["vl_vertices"]),
        vlabel_sets=[tuple(s) for s in d.get("vlabel_sets", [])],
        numeric_value=None if nv is None else np.array(nv),
    )


def _plain(x):
    """Dataclasses -> dicts, lists/tuples kept, arrays copied."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def plan_fields(plan) -> dict:
    """A plan's fields (with its steps, checks and query graph) as plain
    dicts, tuples and numpy arrays."""
    return _plain(plan)


def _query_from_fields(d: dict) -> QueryGraph:
    q = QueryGraph(
        vertices=[QVertex(**v) for v in d["vertices"]],
        edges=[QEdge(**e) for e in d["edges"]],
        var_to_vertex=dict(d["var_to_vertex"]),
        pvars=list(d["pvars"]),
        unsat=bool(d["unsat"]),
    )
    q.param_missing = bool(d.get("param_missing", False))
    return q


def _step_from_fields(d: dict) -> Step:
    d = dict(d)
    d["nontree"] = tuple(NTCheck(**c) for c in d["nontree"])
    d["labels"] = tuple(d["labels"])
    d["num_filters"] = tuple(tuple(f) for f in d["num_filters"])
    return Step(**d)


def plan_from_fields(d: dict) -> ExecPlan:
    """The port's :class:`ExecPlan` from :func:`plan_fields`-shaped values."""
    d = dict(d)
    d["query"] = _query_from_fields(d["query"])
    d["steps"] = [_step_from_fields(s) for s in d["steps"]]
    d["start_candidates"] = np.asarray(d["start_candidates"], np.int32)
    d["order"] = list(d["order"])
    return ExecPlan(**d)


# ------------------------------------------------------------ model zoo

def _named_leaves(tree, prefix: str = "") -> dict:
    """A nested dict / list pytree's leaves under dotted names: ``{"bot":
    {"w": [a, b]}}`` -> ``{"bot.w.0": a, "bot.w.1": b}``, the names
    ``nn.ParameterList`` and submodules give in a state dict."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_named_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def params_from_jax(arch_name: str, tree) -> dict:
    """The port module's ``state_dict`` from the reference's parameter
    pytree (leaves as numpy arrays): ``{"tables": [...], "bot": {"w":
    [...], "b": [...]}, "top": ...}`` for DLRM, ``{"w": [...]}`` for GCN."""
    import torch

    from repro_torch.configs import get_arch

    get_arch(arch_name)  # raises for an arch not ported
    return {k: torch.from_numpy(np.array(v))
            for k, v in _named_leaves(tree).items()}


def adam_state_from_jax(state):
    """The port's :class:`~repro_torch.train.optimizer.AdamWState` from the
    reference's ``AdamWState(step, mu, nu, err)`` (leaves as numpy
    arrays), its moments named like the port module's parameters."""
    import torch

    from repro_torch.train.optimizer import AdamWState

    def named(tree):
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in _named_leaves(tree).items()}

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        mu=named(state.mu), nu=named(state.nu),
        err=None if state.err is None else named(state.err))
