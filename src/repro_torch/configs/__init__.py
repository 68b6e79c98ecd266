"""Architecture registry: ``--arch <id>`` resolution over the reference's
ten assigned archs: the dense LMs, the MoE LMs (DeepSeek-V2 with MLA,
DBRX), the GNNs (GCN, PNA, MeshGraphNet, DimeNet) and DLRM, plus the
paper's own engine workload (``turbohom``, its dry-run cells)."""

from __future__ import annotations

from repro_torch.configs.common import (ArchDef, Cell, GNN_SHAPES, LM_SHAPES,
                                        RECSYS_SHAPES)

_ARCH_MODULES = {
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "dimenet": "repro_torch.configs.dimenet",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "pna": "repro_torch.configs.pna",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "turbohom": "repro_torch.configs.turbohom",
}

ASSIGNED = tuple(k for k in _ARCH_MODULES if k != "turbohom")

def get_arch(name: str) -> ArchDef:
    import importlib

    mod = _ARCH_MODULES.get(name)
    if mod is None:
        raise KeyError(f"arch {name!r} is not ported; ported: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(mod).ARCH


def all_archs() -> list[str]:
    return sorted(_ARCH_MODULES)


__all__ = ["ArchDef", "Cell", "get_arch", "all_archs", "ASSIGNED",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]
