"""Halt-file grid-search monitor (counterpart of
``scripts/monitor_grid_search.py``): report unfinished runs.

The Trainer writes ``<run_id>.done`` into ``paths.grid_search_script_dir``
when ``fit`` ends (``train/loop.py::Trainer._write_halt_file``; reference
on_fit_end halt files, qm9_mol_gen_ddpm.py:1306-1321).

Usage:
  python -m bio_diffusion_torch.cli.monitor_grid_search out_dir/

Prints ``<done>/<total> runs complete`` and one ``PENDING: <cmd>`` line per
unfinished run of ``out_dir/grid_manifest.json``; returns those runs.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__)
        sys.exit(1)
    out_dir = args[0]
    with open(os.path.join(out_dir, "grid_manifest.json")) as f:
        manifest = json.load(f)
    done = {f[:-5] for f in os.listdir(out_dir) if f.endswith(".done")}
    pending = [m for m in manifest if m["run_id"] not in done]
    print(f"{len(manifest) - len(pending)}/{len(manifest)} runs complete")
    for m in pending:
        print("PENDING:", m["cmd"])
    return pending


if __name__ == "__main__":
    main()
