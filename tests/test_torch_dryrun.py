"""The port's dry run, roofline analyzer, perf harness, ``engine_cell`` and
the repaired binary-search midpoint, on the CPU.

- In one process of its own (``torch_dryrun_probe``: fake tensors on the
  CPU, a fake world of 256 ranks): the dry run's command line on
  ``turbohom triangle_q2``, ``gcn-cora full_graph_sm`` and ``dlrm-rm2
  serve_p99``, each ``ok``, the engine cell's all-reduce bytes equal to
  a hand count, no kernel launch; two DTensor products of known sharding
  give their exact FLOPs a rank and all-reduce bytes; the perf harness's
  depth extrapolation equals a direct trace.
- Fake CUDA tensors through the kernel operators: their shape functions
  answer (no build, no launch, no plain version), and the dry run's
  counter costs each call by its kernel's model.
- ``engine_cell``'s step on a one-rank gloo mesh against the reference's
  compiled ``lower_engine_cell`` on the same numpy arrays.
- ``remat_policy="dots"``: loss and gradients equal ``"full"``'s and the
  reference's ``dots`` step; its backward recomputes no product without
  batch dimensions.
- The roofline analyzer's helpers against the reference's.
- ``edge_exists``'s midpoint past 2^30.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.flop_counter import FlopCounterMode

import torch_dryrun_probe
from repro.analysis import roofline as ref_roofline
from repro.configs import get_arch as ref_get_arch
from repro.configs.turbohom import CONFIG as REF_ENGINE
from repro.core.distributed import lower_engine_cell
from repro.kernels import ref as ref_kernels
from repro.models import transformer as ref_tf
from repro_torch.analysis import roofline
from repro_torch.configs import get_arch
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as kref
from repro_torch.launch.sharded import spawn_world
from repro_torch.launch.train import model_for
from repro_torch.models import transformer

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
# the engine's single-pod all-reduces: the count (a sum) and the overflow
# flag (a max), int64 each, once for the one data-parallel group ("data")
ENGINE_ALL_REDUCE = 2 * 8 * 1


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """One process of its own (a fake world of 256 ranks):
    ``torch_dryrun_probe``'s dry-run command line, products and perf
    run, and the directory its records went to."""
    out = tmp_path_factory.mktemp("dryrun")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_probe.py"),
         str(out)], capture_output=True, text=True, env=ENV, timeout=300,
        cwd=ROOT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), out


# ------------------------------------------------------------- dry run


def test_dryrun_cells_in_a_subprocess(probe):
    got, out = probe
    assert got["cli"]["code"] == 0
    summary = got["cli"]["summary"]
    assert summary["ok"] == 3 and summary["failed"] == 0
    assert not any(summary["launches"].values())
    recs = {}
    for c in torch_dryrun_probe.DRYRUN_CELLS:
        arch, cell = c.split(":")
        recs[arch] = json.loads((out / "single" / f"{arch}--{cell}.json")
                                .read_text())
        r = recs[arch]
        assert r["status"] == "ok", r.get("traceback")
        assert r["mesh_shape"] == {"data": 16, "model": 16}
        assert r["depth"] == "full"
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert set(r["memory"]) == {"argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "temp_size_in_bytes"}
    eng = recs["turbohom"]
    assert eng["collective_bytes"] == {"all-reduce": ENGINE_ALL_REDUCE,
                                       "total": ENGINE_ALL_REDUCE}
    # one rank's replica of the graph: 9.08 GB, and its chunk row
    c = REF_ENGINE
    graph = 4 * (c.n_edges + 3 * (c.n_vertices + 1) + c.n_vertices)
    assert eng["memory"]["argument_size_in_bytes"] == graph + 4 * (16 * 16384
                                                                  + 16)
    assert eng["kernel_calls"] == {"bitmap_superset": 3, "edge_exists": 1}
    # DLRM's row-sharded tables: one all-reduce of its bags a table
    assert recs["dlrm-rm2"]["collective_bytes"]["all-reduce"] > 0


def test_dtensor_product_flops_and_all_reduce_bytes(probe):
    recs = probe[0]["product"]
    n, local = 4096, 4096 // 16
    # only the local products: DTensor's own op on global shapes is not
    # counted
    assert recs["a"]["flops"] == 2 * local * n * local
    assert recs["a"]["collective_bytes"] == {"total": 0}
    assert recs["b"]["flops"] == 2 * n * local * n
    assert recs["b"]["collective_bytes"] == {"all-reduce": 4 * n * n,
                                             "total": 4 * n * n}


def test_fake_cuda_tensors_take_the_shape_only_branch(monkeypatch):
    """Fake CUDA tensors through ``ops.edge_exists`` / ``bitmap_superset``
    reach neither the launcher nor a plain version: the operators' shape
    functions answer them, no launch is counted, and the dry run's counter
    sees each as one kernel call, costed by its roofline model."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import kernel_cost
    from repro_torch.launch.dryrun import Counter

    def no_kernel(entry):
        raise AssertionError(f"a fake tensor reached the launcher {entry}")

    def no_plain(*a, **k):
        raise AssertionError("a fake tensor reached a plain version")

    monkeypatch.setattr(_build, "kernel", no_kernel)
    monkeypatch.setattr(kref, "edge_exists_ref", no_plain)
    monkeypatch.setattr(kref, "bitmap_superset_ref", no_plain)
    before = dict(ops.launches)
    with FakeTensorMode():
        nbr = torch.empty(1 << 30, dtype=torch.int32, device="cuda")
        lo = torch.empty(70, dtype=torch.int32, device="cuda")
        bm = torch.empty((1 << 28, 1), dtype=torch.int32, device="cuda")
        req = torch.empty(1, dtype=torch.int32, device="cuda")
        with Counter() as counter:
            got = ops.edge_exists(nbr, lo, lo, lo, n_iters=20)
            sup = ops.bitmap_superset(bm, req, ids=lo)
    assert (tuple(got.shape), got.dtype, got.device.type) == \
        ((70,), torch.bool, "cuda")
    assert (tuple(sup.shape), sup.dtype) == ((70,), torch.bool)
    assert ops.launches == before
    assert counter.kernel_calls == {"edge_exists": 1, "bitmap_superset": 1}
    want = [kernel_cost("edge_exists", expanded=70, n_iters=20),
            kernel_cost("bitmap_superset", expanded=70, bitmap_words=1)]
    assert counter.flops == sum(c["flops"] for c in want)
    assert counter.bytes == sum(c["bytes"] for c in want)


# ---------------------------------------------------------- engine_cell


def _engine_arrays(seed: int, n_v: int, per_label: int):
    """A small engine graph: three label blocks of uniform edges in
    ``(el, src, dst)`` order (rows 1 and 2, then row 0, the join's, last),
    row 2 with half its edges copied from row 0's, the rows' indptr and
    random label words (bit 0 on three quarters of the vertices)."""
    rng = np.random.default_rng(seed)
    base = {1: 0, 2: per_label, 0: 2 * per_label}
    nbr = np.empty(3 * per_label, np.int32)
    iptr = np.empty((3, n_v + 1), np.int32)
    pairs = {}
    for el in (0, 1, 2):
        src = rng.integers(0, n_v, per_label)
        dst = rng.integers(0, n_v, per_label)
        if el == 2:  # half of row 2's edges close with row 0's
            pick = rng.integers(0, per_label, per_label // 2)
            src[:pick.shape[0]] = pairs[0][0][pick]
            dst[:pick.shape[0]] = pairs[0][1][pick]
        key = np.sort(src.astype(np.int64) * n_v + dst)
        src, dst = key // n_v, key % n_v
        pairs[el] = (src, dst)
        nbr[base[el]:base[el] + per_label] = dst
        iptr[el] = np.concatenate(
            [[0], np.cumsum(np.bincount(src, minlength=n_v))]) + base[el]
    words = rng.integers(0, 1 << 32, (n_v, 1), dtype=np.uint64)
    words = (words & ~np.uint64(1)) | (rng.random((n_v, 1)) < 0.75).astype(
        np.uint64)
    return nbr, iptr, words.astype(np.uint32)


def test_engine_cell_matches_reference_compiled_step():
    """Three chunk rows at a capacity that holds them and one at a
    capacity that overflows: the port's ``(count, overflow)`` on a
    one-rank gloo mesh equals the reference's compiled engine step on the
    same arrays."""
    n_v, per_label, chunk = 3000, 6000, 256
    nbr, iptr, words = _engine_arrays(0, n_v, per_label)
    deg0 = np.diff(iptr[0])
    starts = np.flatnonzero(deg0 > 0).astype(np.int32)
    rows = [starts[i * chunk:(i + 1) * chunk] for i in range(3)]
    rows.append(starts[np.argsort(-deg0[starts], kind="stable")][:chunk])
    small = dict(n_vertices=n_v, n_edges=3 * per_label)
    cases = [(4096, r, chunk - 5 * i) for i, r in enumerate(rows[:3])]
    cases.append((512, rows[3], chunk))
    inputs = {"cfg": small, "nbr_el": nbr, "iptr_rows": iptr,
              "label_bitmap": words.view(np.int32),
              "cases": [(cap, r.tolist(), cnt) for cap, r, cnt in cases]}
    got = spawn_world(torch_dryrun_probe.engine_rank, 1, inputs, "cpu",
                      timeout=200)[0]["results"]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cfg = dataclasses.replace(REF_ENGINE, **small)
    want, steps = [], {}
    for cap, row, cnt in cases:
        if cap not in steps:
            meta = {"cap": cap, "chunk": chunk, "n_steps": 3}
            steps[cap] = lower_engine_cell(mesh, cfg, meta,
                                           multi_pod=False).compile()
        c, o = steps[cap](jnp.asarray(nbr), jnp.asarray(iptr), jnp.asarray(words),
                    jnp.asarray(row[None]), jnp.asarray([cnt], jnp.int32))
        want.append([int(c), int(o)])
    assert got == want
    assert [o for _, o in want] == [0, 0, 0, 1]
    assert all(c > 0 for c, _ in want[:3])


# -------------------------------------------------------- remat "dots"


def _lm(policy: str):
    arch = get_arch("qwen3-8b")
    cfg, batch = arch.smoke()
    cfg = dataclasses.replace(cfg, compute_dtype="float32", remat=True,
                              remat_policy=policy)
    model = model_for(arch, cfg, "cpu", torch.Generator().manual_seed(0))
    return model, batch


def _loss_grads(model, batch):
    loss = transformer.loss_fn(model, batch)
    with FlopCounterMode(display=False) as bwd:
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, bwd.get_total_flops()


def test_remat_dots_equals_full_and_saves_the_products():
    """``"dots"`` gives ``"full"``'s loss and gradients within 1e-6
    (float32), and its backward runs fewer FLOPs by exactly the layers'
    forward ``mm`` FLOPs, which it saved instead of recomputing, but for
    each layer's last product (``w_down``): torch's checkpoint stops its
    recompute once the tensors the backward needs are back, so neither
    policy recomputes it."""
    full, batch = _lm("full")
    dots, _ = _lm("dots")
    dots.load_state_dict(full.state_dict())
    lf, gf, bf = _loss_grads(full, batch)
    ld, gd, bd = _loss_grads(dots, batch)
    assert abs(float(lf.detach()) - float(ld.detach())) <= 1e-6
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # the layers' forward products, as the recompute runs them
    cfg = full.cfg
    x = transformer.embed_tokens(full, batch["tokens"], cfg)
    sin, cos = transformer._rope(torch.arange(batch["tokens"].shape[1],
                                              dtype=torch.int32), cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        transformer.run_layers(x, full.layers(), cfg, sin, cos)
    mm = sum(v for k, v in fwd.get_flop_counts()["Global"].items()
             if str(k) in ("aten.mm", "aten.addmm"))
    tokens = batch["tokens"].numel()
    down = 2 * tokens * cfg.d_ff * cfg.d_model * cfg.n_layers
    assert mm > down > 0 and bf - bd == mm - down


def test_remat_dots_matches_reference_dots_step():
    """The port's ``"dots"`` loss and gradients against the reference's
    ``dots`` policy on the same weights (float32, the LM tests' limits)."""
    from repro_torch.convert import params_from_jax

    model, batch = _lm("dots")
    cfg = dataclasses.replace(ref_get_arch("qwen3-8b").smoke()[0],
                              compute_dtype="float32", remat=True,
                              remat_policy="dots")
    named = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    shapes = jax.eval_shape(lambda k: ref_tf.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))

    def stacked(path, leaf):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        for stack in ("dense_layers", "moe_layers"):
            if name.startswith(stack + "."):
                rest = name[len(stack) + 1:]
                return jnp.asarray(np.stack([named[f"{stack}.{i}.{rest}"]
                                             for i in range(leaf.shape[0])]))
        return jnp.asarray(named[name])

    params = jax.tree_util.tree_map_with_path(stacked, shapes)
    jbatch = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(ref_tf.loss_fn),
                     static_argnums=2)(params, jbatch, cfg)
    loss, grads, _ = _loss_grads(model, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    want = {k: v.numpy() for k, v in params_from_jax(
        "qwen3-8b", jax.tree.map(np.asarray, jg)).items()}
    for (k, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------ roofline


RECS = [
    {"flops": 3.5e12, "bytes_accessed": 7.25e9,
     "collective_bytes": {"all-reduce": 1.5e8, "all-gather": 3e6,
                          "total": 1.53e8}},
    {"flops": 1.0e9, "bytes_accessed": 2.0e6,
     "collective_bytes": {"reduce-scatter": 4e5, "collective-permute": 8.0,
                          "total": 400008.0}},
    {"flops": 0.0, "bytes_accessed": 0.0, "collective_bytes": {}},
]


def test_roofline_helpers_match_reference():
    for a in RECS:
        assert roofline._cost_tuple(a) == ref_roofline._cost_tuple(a)
        for b in RECS:
            ca, cb = roofline._cost_tuple(a), roofline._cost_tuple(b)
            assert roofline._sub(ca, cb) == ref_roofline._sub(ca, cb)
            for n in (0, 1, 27, 59):
                assert roofline._combine(ca, cb, n) == \
                    ref_roofline._combine(ca, cb, n)
        # with the reference's constants, the reference's formula
        got = roofline.roofline_terms(
            roofline._cost_tuple(a), peak_flops=ref_roofline.PEAK_FLOPS,
            hbm_bw=ref_roofline.HBM_BW, link_bw=ref_roofline.LINK_BW)
        assert got == ref_roofline.roofline_terms(roofline._cost_tuple(a))
    rows = [{"arch": "qwen3-8b", "cell": "train_4k", "compute_s": 1.25e-2,
             "memory_s": 3e-3, "collective_s": 2e-2, "dominant": "collective",
             "model_flops": 5.3e16, "useful_ratio": 0.31,
             "roofline_frac": 0.2},
            {"arch": "turbohom", "cell": "star_q4", "compute_s": 1e-6,
             "memory_s": 2e-5, "collective_s": 3e-10, "dominant": "memory"}]
    assert roofline.to_markdown(rows) == ref_roofline.to_markdown(rows)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.CHIPS_SINGLE) == (989e12, 3.35e12, 450e9, 256)


def test_perf_depth_extrapolation_equals_full_trace(probe):
    """``perf.measure`` at depth 4 (two traces, differenced) equals a
    direct trace of qwen2-1.5b ``decode_32k`` at 4 layers."""
    m, t = (probe[0]["perf"][k] for k in ("measure", "trace"))
    assert m["flops_per_chip"] == pytest.approx(t["flops"], rel=1e-12)
    assert m["bytes_per_chip"] == pytest.approx(t["bytes_accessed"],
                                                rel=1e-12)
    coll = {k: v for k, v in t["collective_bytes"].items() if k != "total"}
    assert m["coll_per_chip"].keys() == coll.keys()
    for k, v in coll.items():
        assert m["coll_per_chip"][k] == pytest.approx(v, rel=1e-12)
    assert m["flops_per_chip"] > 0 and m["model_flops"] > 0


# ------------------------------------------------------------ midpoint


def test_midpoint_does_not_wrap_past_2_30():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 2**31 - 1, 10_000)
    hi = np.minimum(lo + rng.integers(0, 2**20, 10_000), 2**31 - 1)
    lo[:3], hi[:3] = (2**30 + 10, 2**31 - 2, 0), (2**30 + 50, 2**31 - 1, 0)
    got = kref._midpoint(torch.from_numpy(lo.astype(np.int32)),
                         torch.from_numpy(hi.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), (lo + hi) // 2)
    # the old int32 sum wraps there
    old = (torch.tensor([2**30 + 10], dtype=torch.int32)
           + torch.tensor([2**30 + 50], dtype=torch.int32)) >> 1
    assert int(old) < 0


def test_edge_exists_ref_answers_ranges_past_2_30():
    """A run of equal words over 2^30 + 64 positions (a stride-0 view: no
    4 GB allocation): the contract's answer, ``target ∈ nbr[lo:hi)``,
    for ranges whose ``lo + hi`` passes 2^31 - 1, empty ones included."""
    m = 2**30 + 64
    nbr = torch.full((1,), 7, dtype=torch.int32).as_strided((m,), (0,))
    lo = torch.tensor([2**30, 2**30 + 1, 2**30 + 63, 2**30 + 5],
                      dtype=torch.int32)
    hi = torch.tensor([2**30 + 64, 2**30 + 9, 2**30 + 63, 2**30 + 64],
                      dtype=torch.int32)
    tg = torch.tensor([7, 7, 7, 8], dtype=torch.int32)
    got = kref.edge_exists_ref(nbr, lo, hi, tg, n_iters=32)
    assert got.tolist() == [True, True, False, False]


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_exists_ref_unchanged_below_2_30(seed):
    rng = np.random.default_rng(seed)
    nbr = np.sort(rng.integers(0, 5000, 20_000)).astype(np.int32)
    lo = rng.integers(0, 20_000, 3000).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 300, 3000), 20_000).astype(np.int32)
    tg = rng.integers(0, 5000, 3000).astype(np.int32)
    got = kref.edge_exists_ref(*(torch.from_numpy(a)
                                 for a in (nbr, lo, hi, tg)), n_iters=12)
    want = ref_kernels.edge_exists_ref(*(jnp.asarray(a)
                                         for a in (nbr, lo, hi, tg)),
                                       n_iters=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
