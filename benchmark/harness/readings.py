"""The readings that the limits of `benchmark/limits/` are set from.

    python3 benchmark/harness/readings.py --workload ocr256.batch32 \
        --seconds 3 --seeds 11 12 13 [--control]

runs the cell once per seed in this one process (a short window at the
cell's own load) and prints one JSON line per seed with the numbers
compared. With `--control` the program is replaced by the reference in
the precision below the configuration's (`config["control"]`): those
readings have to come out far above the program's. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def control(spec, seed, device):
    """The substitute that puts the lower-precision reference in the
    program's place."""
    from benchmark.harness import cell

    def sub(program, params):
        return cell.reference(spec, params, seed, device, control=True)
    return sub


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell

    for seed in args.seeds:
        spec = cell.Spec(args.workload)
        sub = control(spec, seed, args.device) if args.control else None
        out = cell.run(spec, seed, args.seconds, False, args.device,
                       time.monotonic(), substitute=sub)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
