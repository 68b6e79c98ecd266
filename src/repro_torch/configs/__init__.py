"""Architecture registry: ``--arch <id>`` resolution over the archs the
port has so far (the reference registers ten plus the engine; the rest
come with later slices)."""

from __future__ import annotations

from repro_torch.configs.common import (ArchDef, Cell, GNN_SHAPES, LM_SHAPES,
                                        RECSYS_SHAPES)

_ARCH_MODULES = {
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}

def get_arch(name: str) -> ArchDef:
    import importlib

    mod = _ARCH_MODULES.get(name)
    if mod is None:
        raise KeyError(f"arch {name!r} is not ported; ported: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(mod).ARCH


def all_archs() -> list[str]:
    return sorted(_ARCH_MODULES)


__all__ = ["ArchDef", "Cell", "get_arch", "all_archs",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]
