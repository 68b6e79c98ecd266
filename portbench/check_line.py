"""Check a run's printed last line against the manifest.

    python3 portbench/check_line.py --workload <cell> --trace <0|1> FILE

``FILE`` holds the run's standard output (its last line is read).  Prints
what is wrong and exits 1, or prints ``ok`` and exits 0.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("file")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import manifest

    lines = Path(args.file).read_text().strip().splitlines()
    if not lines:
        print("no output")
        return 1
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError as e:
        print(f"last line is not JSON: {e}")
        return 1
    bad = manifest.check_line(manifest.load(ROOT / "BENCHMARK.json"),
                              args.workload, bool(args.trace), line)
    for msg in bad:
        print(msg)
    if not bad:
        print("ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
