#!/usr/bin/env python3
"""How far float32 DLRM gradients lie from float64 ones at a train batch.

    PYTHONPATH=src python3 tools/zoo_grad_precision.py [--batch 65536]
        [--cap 100000] [--seed 1] [--device cpu]

Builds ``chip_smoke.py`` phase 9 (b)'s model (DLRM RM-2's widths, each
table capped at ``--cap`` rows, weights from a ``torch.Generator`` seeded
by ``--seed``) and ``RecsysStream``'s batch 0 at ``--batch``, takes the
loss's gradients once in float32 through the port (the embedding bags on
``segment_gather``) and once in float64 (the same model in float64, its
bags a plain float64 gather and masked sum), and prints, per parameter,
the float32 gradient's norm-wise error ``||g32 - g64|| / ||g64||`` and its
largest element error over the leaf's largest ``|g64|``.  The batch's
per-sample terms cancel in each gradient's sum, so these errors say how
closely two float32 runs that sum in different orders (the card's and the
CPU's) can agree.  ``--device cuda`` runs both on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=65_536)
    ap.add_argument("--cap", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import model_for
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.data import RecsysStream
    from repro_torch.train.trainstep import batch_to, named_params

    arch = get_arch("dlrm-rm2")
    cfg = dataclasses.replace(arch.config, vocab_sizes=tuple(
        min(v, args.cap) for v in arch.config.vocab_sizes))
    batch = batch_to(RecsysStream(cfg.n_dense, cfg.n_sparse, cfg.hotness,
                                  cfg.vocab_sizes, batch=args.batch,
                                  seed=0).batch_at(0), args.device)
    model = model_for(arch, cfg, args.device, torch.Generator(
        device=args.device).manual_seed(args.seed))

    def grads(m, b):
        params = named_params(m)
        loss = dlrm.loss_fn(m, b)
        return dict(zip(params, torch.autograd.grad(loss,
                                                    list(params.values()))))

    g32 = grads(model, batch)

    class Float64(dlrm.DLRM):
        """The same model in float64, its bags a plain gather and sum."""

        def forward(self, b):
            def bags(tables, sparse, dtype):
                idx = sparse.permute(1, 0, 2)
                return torch.stack([torch.where(
                    (i >= 0)[:, :, None],
                    t[i.long().clamp(0, t.shape[0] - 1)], 0).sum(1)
                    for t, i in zip(tables, idx)], dim=1)

            embed = dlrm.embed_bags
            dlrm.embed_bags = bags
            try:
                return super().forward(b)
            finally:
                dlrm.embed_bags = embed

    m64 = Float64(dataclasses.replace(cfg, compute_dtype="float64"),
                  device="meta")
    m64.load_state_dict({k: v.detach().double() for k, v in
                         model.state_dict().items()}, assign=True)
    g64 = grads(m64, {k: v.double() if v.is_floating_point() else v
                      for k, v in batch.items()})
    out = {}
    for k, want in g64.items():
        d = g32[k].double() - want
        out[k] = {"norm_rel": float(d.norm() / want.norm()),
                  "max_of_leaf_max": float(d.abs().max()
                                           / want.abs().max())}
    worst = max(v["norm_rel"] for v in out.values())
    print(json.dumps({"batch": args.batch, "cap": args.cap,
                      "device": args.device, "worst_norm_rel": worst,
                      "worst_max_of_leaf_max": max(
                          v["max_of_leaf_max"] for v in out.values()),
                      "leaves": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
