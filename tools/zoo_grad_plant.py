#!/usr/bin/env python3
"""How many single wrong id contributions ``chip_smoke.py`` phase 9 (b)'s
gradient check catches.

    python3 tools/zoo_grad_plant.py [--table 0]

Runs on one CUDA card.  Builds (b)'s inputs (``chip_smoke.zoo_b_models``:
RM-2's widths with each table capped at 100,000 rows, ``RecsysStream``'s
batch 0 at 65,536, weights from seed 1), takes the gradients on the card
and on the CPU and holds them as (b) does (``chip_smoke.zoo_grad_gap``).
Then, per table, for every id of the batch (a contribution ``d_emb[s, t]``
that the table's backward adds to one row), it computes whether (b)'s
limits would fail the card's gradient had the backward dropped that
contribution, or added it twice: by the per-leaf limits alone
(``ZOO_GRAD_NORM_RTOL``, ``ZOO_GRAD_ELEM``) and by the row-by-row limit
(``ZOO_GRAD_TERM``).  Last it plants two faults for real in the card's
backward of table ``--table`` (one id's term dropped: a median term on a
row that one id hits, and a median term on the table's hottest row),
reruns the card's gradients and holds them again.  The report goes to
``chiprun_out/zoo_grad_plant.json``; its summary is the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def catches(torch, cs, g_card, g_cpu, sparse, d_emb, t: int, sign: float):
    """For each id of field ``t``: does (b) fail table ``t``'s gradient
    once ``sign`` times the id's term is added to its row (-1: dropped, +1:
    added twice)?  By the per-leaf limits against the CPU's gradient, and
    by the row limit against the exact sum of the card's terms; all on the
    card."""
    v = g_cpu.shape[0]
    n, exact, s_abs, s_inf = cs.table_terms(torch, sparse, d_emb, t, v)
    idx = sparse[:, t, :]
    keep = idx >= 0
    rows = idx.long().clamp(max=v - 1)[keep]
    e = d_emb[:, t, None, :].expand(-1, idx.shape[1], -1)[keep]
    d = g_card - g_cpu
    dr = d[rows] + sign * e  # the planted row's difference from the CPU's
    norm2 = float(d.double().pow(2).sum()) - d[rows].double().pow(2).sum(1) \
        + dr.double().pow(2).sum(1)
    leaf = (norm2.clamp(min=0).sqrt() / float(g_cpu.norm())
            > cs.ZOO_GRAD_NORM_RTOL) | (
        dr.abs().amax(1) / float(g_cpu.abs().max()) > cs.ZOO_GRAD_ELEM)
    row = cs.term_excess(
        torch, (g_card.double() - exact)[rows] + sign * e.double(), n[rows],
        s_abs[rows], s_inf[rows]) > cs.ZOO_GRAD_TERM
    return {"ids": int(rows.numel()),
            "caught_per_leaf": float(leaf.float().mean()),
            "caught_by_row": float(row.float().mean()),
            "caught_either": float((leaf | row).float().mean()),
            "ids_on_rows_over_4000": float((n[rows] > 4000).float().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels.autograd import EmbeddingBagSum

    if not torch.cuda.is_available():
        print("zoo_grad_plant: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch, card, cpu = cs.zoo_b_models(torch, get_arch("dlrm-rm2"))
    sparse = torch.from_numpy(batch["sparse"]).cuda()
    _, g_cpu, e_cpu = cs.zoo_grads(torch, cpu, batch)
    _, g_card, d_emb = cs.zoo_grads(torch, card, batch)
    base = cs.zoo_grad_gap(torch, g_card, g_cpu, sparse, d_emb)
    # the bags' gradients on the two sides, per sample and field, as a
    # share of the CPU's largest |element|
    rel = ((d_emb.cpu() - e_cpu).abs().amax(-1)
           / e_cpu.abs().amax(-1).clamp(min=1e-30)).flatten()
    report = {"rows": sum(cfg.vocab_sizes), "batch": cs.ZOO_BATCH,
              "limits": {"norm_rtol": cs.ZOO_GRAD_NORM_RTOL,
                         "elem": cs.ZOO_GRAD_ELEM, "term": cs.ZOO_GRAD_TERM},
              "d_emb_card_vs_cpu": {
                  "max": float(rel.max()),
                  "q0.9999": float(rel.quantile(0.9999)),
                  "share_over_1e-3": float((rel > 1e-3).float().mean())},
              "unplanted": base, "tables": {}}
    for t, v in enumerate(cfg.vocab_sizes):
        key = f"tables.{t}"
        report["tables"][key] = {"rows": v, **{
            what: catches(torch, cs, g_card[key], g_cpu[key].cuda(), sparse,
                          d_emb, t, sign)
            for what, sign in (("dropped", -1.0), ("doubled", 1.0))}}

    # two faults planted in the card's backward of one table
    t = args.table
    key, v = f"tables.{t}", cfg.vocab_sizes[t]
    field = sparse[:, t, :].contiguous()
    n = torch.bincount(field[field >= 0].long().clamp(max=v - 1),
                       minlength=v)
    slots = (field >= 0).nonzero()
    rows = field[slots[:, 0], slots[:, 1]].long().clamp(max=v - 1)
    size = d_emb[slots[:, 0], t].abs().amax(1)

    def median_slot(mask):
        cand = mask.nonzero()[:, 0]
        order = size[cand].argsort()
        return cand[order[order.numel() // 2]]

    orig = EmbeddingBagSum.backward
    report["planted"] = {}
    for what, mask in (("one-id row", n[rows] == 1),
                       ("hottest row", rows == int(n.argmax()))):
        i = median_slot(mask)
        s, r = int(slots[i, 0]), int(rows[i])

        def planted(ctx, d_out, s=s, r=r):
            d_table, d_idx, d_w = orig(ctx, d_out)
            if torch.equal(ctx.saved_tensors[0], field):
                d_table[r] -= d_out[s]  # the id's term, dropped
            return d_table, d_idx, d_w

        EmbeddingBagSum.backward = staticmethod(planted)
        try:
            _, g_bad, _ = cs.zoo_grads(torch, card, batch)
        finally:
            EmbeddingBagSum.backward = staticmethod(orig)
        gap = cs.zoo_grad_gap(torch, {key: g_bad[key]}, {key: g_cpu[key]},
                              sparse, d_emb)[key]
        report["planted"][what] = {
            "table": t, "sample": s, "row": r, "row_ids": int(n[r]),
            "term_max_abs": float(size[i]), **gap,
            "per_leaf_ok": gap["norm_rel"] <= cs.ZOO_GRAD_NORM_RTOL
            and gap["max_of_leaf_max"] <= cs.ZOO_GRAD_ELEM}

    summary = {
        "unplanted_ok": all(w["ok"] for w in base.values()),
        "worst_term_excess": max(w.get("term_excess", 0.0)
                                 for w in base.values()),
        "dropped_caught_per_leaf": [min(
            x["dropped"]["caught_per_leaf"]
            for x in report["tables"].values()),
            max(x["dropped"]["caught_per_leaf"]
                for x in report["tables"].values())],
        "dropped_caught_either": [min(
            x["dropped"]["caught_either"] for x in report["tables"].values()),
            max(x["dropped"]["caught_either"]
                for x in report["tables"].values())],
        "d_emb_card_vs_cpu_max": report["d_emb_card_vs_cpu"]["max"],
        "planted_failed": {w: not p["ok"]
                           for w, p in report["planted"].items()}}
    report["summary"] = summary
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "zoo_grad_plant.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
