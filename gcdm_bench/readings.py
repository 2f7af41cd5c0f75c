"""The numbers a cell compares, over many seeds in one process: the
program's, with ``--control`` the control's beside them, or with ``--fault``
those of a run with a fault planted in the timed path.  This is how the
limits in ``limits/<workload>.json`` are set; the benchmark's own runs do
not run it.

    python3 gcdm_bench/readings.py --workload qm9_train_b64 --seconds 1 --control --seeds 11 12 13

prints one JSON line a seed: the seed, the fault, ``correct`` and every reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gcdm_bench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    run.pin_threads()
    failures = 0
    for seed in args.seeds:
        argv_run = ["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)]
        try:
            res = run.execute(run.parse(argv_run + (["--control"] if args.control else [])), fault=args.fault)
        except Exception:  # a run that crashes gives no number; the others go on
            traceback.print_exc()
            print(json.dumps({"seed": seed, "fault": args.fault, "error": True}), flush=True)
            failures += 1
            continue
        readings = {k: c["value"] for k, c in res["checks"].items()}
        readings.update(res["controls"])
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": res["correct"], "readings": readings}),
              flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
