"""Grid-search run generation (counterpart of
``scripts/generate_grid_search_runs.py`` and of the reference's
scripts/generate_*_grid_search_runs.py + Nautilus templates).

Takes a JSON search space (lists of values per dotted config key), emits the
itertools product as (a) a JSON manifest and (b) one launch line per run.
Run completion is signaled by ``<run_id>.done`` halt files written by the
Trainer (``train/loop.py``) when ``paths.grid_search_script_dir`` is set, so
``cli.monitor_grid_search`` can list unfinished runs and
``cli.generate_k8s_jobs`` can turn the manifest into GPU Jobs.

Usage:
  python -m bio_diffusion_torch.cli.generate_grid_search_runs search_space.json out_dir/ \\
      [--entry "python -m bio_diffusion_torch.cli.train experiment=qm9_mol_gen_ddpm"]

search_space.json example:
  {"model.optimizer.lr": [1e-4, 4e-4],
   "model.model_cfg.num_encoder_layers": [4, 9],
   "model.diffusion_cfg.num_timesteps": [1000]}
"""

from __future__ import annotations

import itertools
import json
import os
import sys

DEFAULT_ENTRY = "python -m bio_diffusion_torch.cli.train"


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 2:
        print(__doc__)
        sys.exit(1)
    space_path, out_dir = args[0], args[1]
    entry = args[args.index("--entry") + 1] if "--entry" in args else DEFAULT_ENTRY

    with open(space_path) as f:
        space = json.load(f)
    keys = sorted(space)
    combos = list(itertools.product(*(space[k] for k in keys)))

    os.makedirs(out_dir, exist_ok=True)
    manifest, lines = [], []
    for i, combo in enumerate(combos):
        run_id = f"run_{i:04d}"
        overrides = [f"{k}={v}" for k, v in zip(keys, combo)]
        cmd = (f"{entry} {' '.join(overrides)} "
               f"paths.grid_search_script_dir={out_dir} task_name={run_id} "
               f"--workdir={os.path.join(out_dir, run_id)}")
        manifest.append({"run_id": run_id, "overrides": dict(zip(keys, combo)), "cmd": cmd})
        lines.append(cmd)

    with open(os.path.join(out_dir, "grid_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    launch = os.path.join(out_dir, "launch_all.sh")
    with open(launch, "w") as f:
        f.write("#!/bin/bash\nset -e\n" + "\n".join(lines) + "\n")
    os.chmod(launch, 0o755)
    print(f"wrote {len(combos)} runs to {out_dir} (manifest + launch_all.sh)")
    return manifest


if __name__ == "__main__":
    main()
