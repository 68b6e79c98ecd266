"""The port's cell builders and model FLOPs against the reference's.

- ``model_flops``: exactly the reference's value for each of the 40
  (arch, cell) pairs of the ten assigned archs.
- ``build_cell``: for every cell of every arch (the engine's two too), the
  port's abstract arguments (parameters, optimizer state, batch, cache)
  against the reference's ``build_cell`` on a one-device ``("data",
  "model")`` mesh, leaf for leaf in shape and dtype, the reference's
  layer-stacked leaves split one a layer (``convert``'s names); the GNN
  ``shard_map`` / ``shard_map_v2`` padding for 16 shards against the
  reference's padding; the LM profile grammar against the reference's.

No process group is joined: the port's builder reads only a mesh's axis
names, sizes and this rank's coordinates, which a stub gives.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.analysis.model_flops import model_flops as ref_model_flops
from repro.configs import ASSIGNED
from repro.configs import all_archs as ref_all_archs
from repro.configs import get_arch as ref_get_arch
from repro.launch.cells import build_cell as ref_build_cell
from repro.sharding import gnn_spmd as ref_gnn_spmd
from repro_torch.analysis.model_flops import model_flops
from repro_torch.convert import _STACKED, _named_leaves
from repro_torch.launch.cells import build_cell
from repro_torch.train.optimizer import AdamWState

PAIRS = [(a, c) for a in ASSIGNED for c in sorted(ref_get_arch(a).cells)]
CELLS = [(a, c) for a in ref_all_archs() for c in sorted(ref_get_arch(a).cells)]
# the reference's dtypes in the port: label words are int32 bit patterns
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "uint32": torch.int32, "bool": torch.bool}


class StubMesh:
    """What ``build_cell`` reads of a mesh: axis names, sizes, this
    rank's coordinates (all 0)."""

    def __init__(self, names=("data", "model"), shape=(1, 1)):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.ndim = len(shape)

    def get_local_rank(self, axis):
        return 0

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]


@pytest.fixture(scope="module")
def ref_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_every_pair_is_assigned():
    assert len(PAIRS) == 40
    assert len(CELLS) == 42


@pytest.mark.parametrize("arch,cell", PAIRS)
def test_model_flops_equal_reference(arch, cell):
    assert model_flops(arch, cell) == ref_model_flops(arch, cell)


# ------------------------------------------------------------- build_cell


def _ref_leaves(tree) -> dict:
    """``name -> (shape, dtype)`` of a reference pytree of abstract leaves
    under the port's names: a stacked ``dense_layers.<leaf>`` /
    ``moe_layers.<leaf>`` becomes ``dense_layers.{i}.<leaf>``."""
    out = {}
    for k, v in _named_leaves(tree).items():
        shape, dtype = tuple(v.shape), DTYPES[str(v.dtype)]
        stack = next((p for p in _STACKED if k.startswith(p)), None)
        if stack is None:
            out[k] = (shape, dtype)
            continue
        for i in range(shape[0]):
            out[f"{stack}{i}.{k[len(stack):]}"] = (shape[1:], dtype)
    return out


def _port_leaves(tree) -> dict:
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    return {k: (tuple(v.shape), v.dtype)
            for k, v in _named_leaves(tree).items()}


def _state(state, ref: bool) -> dict:
    """An AdamW state's leaves: ``step`` and each moment's under
    ``mu.`` / ``nu.`` (``err`` where it is kept)."""
    leaves = _ref_leaves if ref else _port_leaves
    out = {"step": leaves({"step": state.step})["step"]}
    for part in ("mu", "nu", "err"):
        tree = getattr(state, part)
        if tree is not None:
            out.update({f"{part}.{k}": v for k, v in leaves(tree).items()})
    return out


def _args(args, ref: bool) -> list[dict]:
    leaves = _ref_leaves if ref else _port_leaves
    out = []
    for a in args:
        is_state = (type(a).__name__ == "AdamWState") if ref \
            else isinstance(a, AdamWState)
        out.append(_state(a, ref) if is_state else leaves(a))
    return out


@pytest.mark.parametrize("arch,cell", CELLS)
def test_build_cell_args_match_reference(ref_mesh, arch, cell):
    got = build_cell(arch, cell, StubMesh())
    want = ref_build_cell(arch, cell, ref_mesh)
    assert got["family"] == want["family"]
    if want["family"] == "engine":
        infos = jax.tree.leaves(want["lower"]().args_info)
        assert [(tuple(a.shape), a.dtype) for a in got["args"]] == \
            [(tuple(i.shape), DTYPES[str(i.dtype)]) for i in infos]
        return
    assert _args(got["args"], False) == _args(want["args"], True)
    for flag in ("remat", "remat_policy", "attn_fp32_logits"):
        if hasattr(want["cfg"], flag):
            assert getattr(got["cfg"], flag) == getattr(want["cfg"], flag)


@pytest.mark.parametrize("arch,profile,pads", [
    ("gcn-cora", "shard_map", True),
    ("pna", "shard_map", True),
    ("meshgraphnet", "shard_map", True),
    # DimeNet shards its 8e triplets, which 16 divides; v2 its edges too
    ("dimenet", "shard_map", False),
    ("dimenet", "shard_map_v2", True),
])
def test_spmd_padding_for_16_shards_matches_reference(arch, profile, pads):
    """The ``shard_map`` profiles pad the sharded fields of
    ``full_graph_sm`` (10,556 edges) to a multiple of 16 shards as the
    reference's builder does (its padding, from the reference's
    ``pad_gnn_batch_abstract`` and its v2 edge padding)."""
    cell = "full_graph_sm"
    got = build_cell(arch, cell, StubMesh(shape=(16, 1)), profile=profile)
    batch = ref_get_arch(arch).input_specs(cell)
    n_seg = batch["edge_src"].shape[0] if arch == "dimenet" \
        else (batch["x"].shape[0] if "x" in batch else batch["pos"].shape[0])
    want = ref_gnn_spmd.pad_gnn_batch_abstract(arch, batch, 16, n_seg)
    if profile == "shard_map_v2":
        for f in ("edge_src", "edge_dst"):
            e = want[f].shape[0]
            want[f] = jax.ShapeDtypeStruct((e + (-e) % 16,), want[f].dtype)
    assert _port_leaves(got["args"][2]) == _ref_leaves(want)
    padded = [k for k in want if want[k].shape != batch[k].shape]
    assert bool(padded) == pads
    assert got["cfg"].spmd_axes == ("data", "model")


@pytest.mark.parametrize("profile", [
    "baseline", "act_replicated", "act_seq", "act_seq+bf16logits",
    "baseline+dots", "act_replicated+dots+noremat", "baseline+nosuchflag",
    "nosuchmode", "", "+dots"])
def test_profile_grammar_matches_reference(ref_mesh, profile):
    """A profile the reference's builder refuses, the port's refuses with
    the same error; one it takes sets the same config flags."""
    try:
        want = ref_build_cell("qwen2-1.5b", "train_4k", ref_mesh,
                              lm_depth=(1, 0), profile=profile)
    except Exception as e:  # noqa: BLE001 - compared below
        with pytest.raises(type(e)):
            build_cell("qwen2-1.5b", "train_4k", StubMesh(),
                       lm_depth=(1, 0), profile=profile)
        return
    got = build_cell("qwen2-1.5b", "train_4k", StubMesh(), lm_depth=(1, 0),
                     profile=profile)
    for flag in ("remat", "remat_policy", "attn_fp32_logits", "n_layers"):
        assert getattr(got["cfg"], flag) == getattr(want["cfg"], flag)
    assert tuple(got["cfg"].act_spec) == tuple(
        None if a is None else a for a in want["cfg"].act_spec)


def test_lm_depth_keeps_reference_meaning(ref_mesh):
    """``lm_depth=(n_dense, n_moe)``: DeepSeek-V2 at (1, 2) has one dense
    and two MoE layers in both packages."""
    got = build_cell("deepseek-v2-236b", "decode_32k", StubMesh(),
                     lm_depth=(1, 2))
    want = ref_build_cell("deepseek-v2-236b", "decode_32k", ref_mesh,
                          lm_depth=(1, 2))
    assert (got["cfg"].n_layers, got["cfg"].moe.first_dense_layers) == \
        (want["cfg"].n_layers, want["cfg"].moe.first_dense_layers) == (3, 1)
    assert _args(got["args"], False) == _args(want["args"], True)
    assert dataclasses.replace(got["cfg"], act_spec=None,
                               logits_spec=None).unroll_layers
