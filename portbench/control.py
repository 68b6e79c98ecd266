"""The control of a cell's correctness check: the plain reference put in
the port's place with one of the deployment's guarantees broken, judged
by the same comparison a run makes.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--requests N]

For each seed it generates the cell's data, draws the first ``N``
requests of the cell's traffic (round robin over its clients, as a run
sends them), answers each with the broken reference and prints one JSON
line with the count of answers the check calls wrong.  The broken
guarantee: the RDFS subclass closure (stated types only).  A sound
control reads above the check's limit of 0 on every seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_reading(man, cell_name: str, seed: int, requests: int,
                    cfg=None, mix=None) -> dict:
    from portbench import bench, manifest, traffic
    from portbench.check import Checker
    from portbench.gen import lubm

    cell = manifest.cell(man, cell_name)
    cfg = cfg or manifest.config(man, cell)
    mix = mix or manifest.mix(cell)
    t = time.perf_counter()
    ds = lubm.generate(cfg, seed)
    term_id = ds.term_ids()
    right = bench.reference_graph(ds, term_id=term_id)
    broken = bench.reference_graph(ds, closure=False, term_id=term_id)
    what = "stated types only (no subclass closure)"
    checker = Checker(ds, right, maps=None, term_id=term_id)
    traf = traffic.Traffic(mix, ds, seed)
    streams = [traf.stream(k) for k in range(int(mix["clients"]))]
    memo: dict[str, bool] = {}
    wrong = 0
    for i in range(requests):
        req = next(streams[i % len(streams)])
        ok = memo.get(req.text)
        if ok is None:
            ok = memo[req.text] = checker.matches(
                req.text, broken.answer(checker.reference(req.text)[0]))
        wrong += not ok
    return {"workload": cell_name, "seed": seed, "control": what,
            "requests": requests, "wrong_answers": wrong,
            "distinct": len(memo), "seconds": time.perf_counter() - t}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import manifest

    man = manifest.load(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_reading(man, args.workload, seed,
                                         args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
