from repro_torch.core.distributed import (GreedyChunker, engine_chunk_step,
                                          run_sharded)
from repro_torch.core.exec import DeviceGraph, ExecOpts, Executor, Result
from repro_torch.core.planner import (CostModel, ExecPlan, PlanError,
                                      build_plan, choose_start_vertex)
from repro_torch.core.query import QueryGraph, build_query_graph
from repro_torch.core.sparql_exec import (CompiledBranch, CompiledOptional,
                                          CompiledQuery, QueryResult,
                                          SparqlEngine)

__all__ = [
    "DeviceGraph",
    "ExecOpts",
    "Executor",
    "Result",
    "CostModel",
    "ExecPlan",
    "PlanError",
    "build_plan",
    "choose_start_vertex",
    "QueryGraph",
    "build_query_graph",
    "QueryResult",
    "SparqlEngine",
    "CompiledQuery",
    "CompiledBranch",
    "CompiledOptional",
    "GreedyChunker",
    "engine_chunk_step",
    "run_sharded",
]
