"""Where the wall time of ``chip_smoke.py`` goes, phase by phase, and how two
checkouts' smokes compare.

Usage:
  python -m bio_diffusion_torch.cli.smoke_phases run DIR OUT
  python -m bio_diffusion_torch.cli.smoke_phases compare OUT [OUT ...]

``run`` starts ``python3 -u chip_smoke.py`` in the checkout DIR (after
removing its built kernels and its ``outputs/``, so that every run builds
and writes the same), stamps each line of its standard output with the
seconds since the start, writes the stamped lines to OUT and exits with the
smoke's code.  ``compare`` cuts each stamped output at the first line of each
phase's end (``PHASES``; a phase whose end a run lacks is merged into the
next) and prints one row a phase, one column a run, in seconds; the last line
is one JSON object of the same numbers.  Compare an older checkout's smoke
with this one's in one call, in turns (older, this, this, older).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List

# (phase, the start of the line that ends it), in the order the smoke runs them
PHASES = (
    ("start and kernel build", "built "),
    ("B1, B2, B3 against plain; unfused path", "unfused path: "),
    ("denoiser card against CPU", "warmup bucket "),
    ("server requests", "seeded pair identical"),
    ("reverse step", "reverse step "),
    ("trainer fp32 and bf16", "train bf16: the two kernels"),
    ("user path", "user path phase"),
    ("data parallel", "data parallel phase"),
    ("conditional path", "conditional path phase"),
    ("GEOM path", "GEOM path phase"),
    ("pocket path", "pocket path phase"),
    ("chain path", "chain path phase"),
    ("sweep path", "sweep path phase"),
    ("serving benchmarks", "serving benchmarks phase"),
    ("debug and profile", "debug and profile phase"),
    ("pass probe", '{"kernels"'),
    ("kernels line to the end", '{"ok"'),
)
_STAMPED = re.compile(r"^\s*(\d+\.\d+) (.*)$")


def run(checkout: str, out_path: str) -> int:
    """Run DIR's smoke with each output line stamped; returns its exit code."""
    for stale in ("bio_diffusion_torch/build", "outputs"):
        shutil.rmtree(os.path.join(checkout, stale), ignore_errors=True)
    t0 = time.time()
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=checkout, stdout=subprocess.PIPE,
                                text=True)
        for line in proc.stdout:
            out.write(f"{time.time() - t0:9.3f} {line}")
            out.flush()
        rc = proc.wait()
        out.write(f"{time.time() - t0:9.3f} [exit {rc}]\n")
    return rc


def phase_seconds(stamped: List[str]) -> Dict[str, float]:
    """Seconds of each phase of one stamped output, and its ``total``."""
    lines = [(float(m.group(1)), m.group(2)) for m in map(_STAMPED.match, stamped) if m]
    out, start, i, name_so_far = {}, 0.0, 0, []
    for name, end in PHASES:
        name_so_far.append(name)
        j = next((j for j in range(i, len(lines)) if lines[j][1].startswith(end)), None)
        if j is None:
            continue
        out[" + ".join(name_so_far)] = lines[j][0] - start
        start, i, name_so_far = lines[j][0], j + 1, []
    out["total"] = lines[-1][0] if lines else 0.0
    return out


def compare(paths: List[str]) -> Dict[str, Dict[str, float]]:
    """Each output's phase seconds, by path; printed as a table."""
    runs = {}
    for path in paths:
        with open(path) as f:
            runs[path] = phase_seconds(f.readlines())
    rows = list(dict.fromkeys(name for r in runs.values() for name in r))
    print(f"{'phase':>46} " + " ".join(f"{os.path.basename(p)[-14:]:>14}" for p in paths))
    for name in rows:
        cells = " ".join(f"{runs[p][name]:14.3f}" if name in runs[p] else f"{'-':>14}" for p in paths)
        print(f"{name[-46:]:>46} {cells}")
    print(json.dumps(runs))
    return runs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 3 and argv[0] == "run":
        return run(argv[1], argv[2])
    if len(argv) >= 2 and argv[0] == "compare":
        compare(argv[1:])
        return 0
    print(__doc__.strip())
    return 0 if argv in (["--help"], ["-h"]) else 2


if __name__ == "__main__":
    sys.exit(main())
