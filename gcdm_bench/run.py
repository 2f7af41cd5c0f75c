"""Run one cell of the benchmark once and print its result line.

    python3 gcdm_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error.  Without CUDA, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with another code than 0.

``--control`` (not used by the benchmark's own runs) also reads the
control: the plain reference in TF32 put in the program's place.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(REPO))

# caches of the program's builds stay at fixed places inside the checkout;
# a library that would load JAX by itself is kept from doing so
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "gcdm_bench" / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(REPO / "gcdm_bench" / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--manifest", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def execute(args, device=None, root=None, fault=None) -> dict:
    """Run the cell -> the pieces of its result.  ``device`` other than None
    skips the look for cards (the harness's own tests on the CPU)."""
    import torch

    from gcdm_bench import harness
    from gcdm_bench.program import Run

    manifest = harness.load_manifest(args.manifest)
    cell = harness.cell(manifest, args.workload)
    root = Path(root) if root else harness.ROOT
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    config = harness.read_json("configs", cell["config"], root)
    spec = harness.read_json("traffic", cell["traffic"], root)
    limits = harness.read_json("limits", args.workload, root)
    run = Run(args.workload, config, spec, args.seed, args.seconds, bool(args.trace),
              torch.device(device), T_START, control=args.control, fault=fault)
    harness.load("drivers", spec["kind"], root).drive(run)
    out = run.out
    checks = harness.judge(out["readings"], limits)
    if args.trace:
        metrics = harness.read_per_layer(manifest, args.workload, out["ctx"], root)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in harness.end_to_end(manifest, args.workload)}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out["peak_bytes"])}
    if run.device.type == "cuda":
        from gcdm_bench.yardstick import power_limit

        dev["power_limit"] = power_limit()
    summary = out.get("trace")
    if args.trace and summary:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
    return {"correct": harness.passed(checks), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev, "checks": checks,
            "breakdown": summary["breakdown"] if args.trace and summary else None,
            "controls": {k: v for k, v in out["readings"].items() if k.startswith("control.")}}


def pin_threads() -> None:
    """One host thread for the CPU's own work: the runs of a host-bound cell
    should not share the host with a pool of workers beside the launching thread."""
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)


def main(argv=None) -> int:
    args = parse(argv)
    pin_threads()
    res = execute(args)
    from gcdm_bench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process, which no run may load: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value in res["controls"].items():
        print(f"{name}: {value!r}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = harness.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"], res["device"],
                               res["checks"], res["breakdown"])
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
