"""The system under test, built from a generated data set: the port's
loader, store, engine and scheduler, as the deployment's file says.

The data goes in as strings through the port's own dictionary and triple
store; the window calls what :func:`call_for` returns.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from portbench.gen import lubm


@dataclass
class System:
    cfg: dict
    maps: object
    engine: object  # the SparqlEngine the window queries (or the registry's)
    registry: object | None = None
    scheduler: object | None = None
    dataset_name: str = "lubm"
    phases: dict = field(default_factory=dict)


def load_graph(ds: lubm.Dataset):
    """Hand every triple of ``ds`` to the port's loader as a user's load
    does: string triples into its ``TripleStore`` (its dictionary interns
    each term and predicate), then its type-aware transform, which
    finalizes the store and builds the labeled graph.  Returns
    ``(graph, maps)``."""
    from repro_torch.rdf.transform import type_aware_transform
    from repro_torch.rdf.triples import TripleStore

    t, q = ds.terms, ds.predicates
    store = TripleStore()
    store.add_many(zip(map(t.__getitem__, ds.s.tolist()),
                       map(q.__getitem__, ds.p.tolist()),
                       map(t.__getitem__, ds.o.tolist())))
    return type_aware_transform(store)


def build(cfg: dict, mix: dict, ds: lubm.Dataset, device: str) -> System:
    """The store, engine and (for the ``scheduler`` entry) scheduler of
    deployment ``cfg`` over ``ds``."""
    from repro_torch.core import SparqlEngine

    phases = {}
    t = time.perf_counter()
    g, maps = load_graph(ds)
    phases["load_s"] = time.perf_counter() - t
    phases["vertices"], phases["edges"] = int(g.n_vertices), int(g.n_edges)

    t = time.perf_counter()
    if mix["entry"] == "engine":
        engine = SparqlEngine(g, maps, device=device)
        sys_ = System(cfg, maps, engine, phases=phases)
    elif mix["entry"] == "scheduler":
        from repro_torch.serve.metrics import ServeMetrics
        from repro_torch.serve.scheduler import Scheduler
        from repro_torch.serve.server import DatasetRegistry

        sv = cfg["serving"]
        metrics = ServeMetrics()
        reg = DatasetRegistry(metrics,
                              result_cache_size=sv["result_cache_size"],
                              feedback=sv["feedback"], device=device)
        ds_ = reg.register(System.dataset_name, g, maps)
        sched = Scheduler(reg, workers=sv["workers"],
                          max_queue=sv["max_queue"],
                          default_timeout_s=sv["timeout_s"],
                          metrics=metrics, batch_max=sv["batch_max"],
                          batch_window_ms=sv["batch_window_ms"]).start()
        sys_ = System(cfg, maps, ds_.engine, registry=reg, scheduler=sched,
                      phases=phases)
    else:
        raise ValueError(f"unknown entry {mix['entry']!r}")
    phases["engine_s"] = time.perf_counter() - t
    return sys_


def call_for(sys_: System, mix: dict):
    """The one call a client makes per request: ``call(text) -> result``."""
    collect = mix.get("collect", "bindings")
    if mix["entry"] == "engine":
        eng = sys_.engine
        return lambda text: eng.query(text, collect=collect)
    sched, name = sys_.scheduler, sys_.dataset_name
    return lambda text: sched.submit(name, text)


def warm_batches(sys_: System, texts_by_query: dict[str, list[str]],
                 batch_max: int) -> None:
    """Run every shape of the mix as a family batch of each padded lane
    count up to ``batch_max`` (1, 2, 4, ...), straight through the
    registry, so the window builds no batch program."""
    from repro_torch.serve.fingerprint import parameterize_query

    reg, name = sys_.registry, sys_.dataset_name
    for texts in texts_by_query.values():
        lanes = 1
        while lanes <= batch_max:
            pqs = [parameterize_query(texts[i % len(texts)])
                   for i in range(lanes)]
            for r in reg.execute_canonical_batch(name, pqs,
                                                 reg.version(name)):
                if isinstance(r, Exception):
                    raise r
            lanes *= 2
